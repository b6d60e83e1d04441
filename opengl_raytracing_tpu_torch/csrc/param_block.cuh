// The parameter block as the kernels read it: the C mirror of
// models/param_block.py's FIELDS, in the same order, every word float32.
// The block holds every data field of RenderParams and the values the
// host derives from them (the point light's world position, the sun and
// sky vectors, colour * intensity products, the gradient sky's ends,
// get_material's table, TAA/AO/SVGF constants).  A kernel takes a device
// pointer to it, as it takes the frame's record, so that a captured CUDA
// graph replays the call for any value of the parameters.
//
// Each library exports ort_param_block_layout, which the host compares
// with FIELDS when it loads the library.

#ifndef ORT_PARAM_BLOCK_CUH_
#define ORT_PARAM_BLOCK_CUH_

#include <stddef.h>

// X(name, words), in block order
#define ORT_PARAM_FIELDS(X) \
  X(exposure, 1) \
  X(mat_albedo_color, 3) \
  X(mat_albedo_spec_strength, 1) \
  X(mat_albedo_gloss, 1) \
  X(mat_glass_color, 3) \
  X(mat_glass_ior, 1) \
  X(mat_glass_distortion, 1) \
  X(mat_mirror_color, 3) \
  X(mat_mirror_gloss, 1) \
  X(jitter_still_scale, 1) \
  X(jitter_moving_scale, 1) \
  X(gi_scale_analytic, 1) \
  X(gi_scale_bvh, 1) \
  X(env_map_intensity, 1) \
  X(sun_color, 3) \
  X(sun_intensity, 1) \
  X(sun_yaw, 1) \
  X(sun_pitch, 1) \
  X(sky_color, 3) \
  X(sky_intensity, 1) \
  X(sky_yaw, 1) \
  X(sky_pitch, 1) \
  X(point_light_color, 3) \
  X(point_light_intensity, 1) \
  X(point_light_pos, 3) \
  X(point_light_orbit_radius, 1) \
  X(point_light_orbit_speed, 1) \
  X(point_light_yaw, 1) \
  X(point_light_pitch, 1) \
  X(ao_radius, 1) \
  X(ao_bias, 1) \
  X(ao_min, 1) \
  X(taa_still_thresh, 1) \
  X(taa_hard_moving_thresh, 1) \
  X(taa_history_min_weight, 1) \
  X(taa_history_avg_weight, 1) \
  X(taa_history_max_weight, 1) \
  X(taa_history_box_size, 1) \
  X(svgf_var_max, 1) \
  X(svgf_k_var, 1) \
  X(svgf_k_color, 1) \
  X(svgf_k_var_motion, 1) \
  X(svgf_k_color_motion, 1) \
  X(svgf_strength, 1) \
  X(motion_scale, 1) \
  X(point_light_world, 3) \
  X(sun_dir, 3) \
  X(sky_up, 3) \
  X(sun_li, 3) \
  X(sky_li, 3) \
  X(sky_top, 3) \
  X(sky_bottom, 3) \
  X(mat_albedo, 15) \
  X(mat_spec, 5) \
  X(mat_gloss, 5) \
  X(mat_ior, 5) \
  X(ao_span, 1) \
  X(taa_w_curr, 3) \
  X(taa_hard_span, 1) \
  X(taa_hard_span_inv, 1) \
  X(svgf_strength_clamped, 1) \
  X(svgf_dk_var, 1) \
  X(svgf_dk_color, 1)

struct ParamBlock {
#define ORT_PARAM_DECL(name, words) float name[words];
  ORT_PARAM_FIELDS(ORT_PARAM_DECL)
#undef ORT_PARAM_DECL
};

// Each field's first word, in block order, into `words` (room for `cap`);
// returns the number of fields, then the words the struct spans.
extern "C" int ort_param_block_layout(int* words, int cap) {
  int k = 0;
#define ORT_PARAM_OFFSET(name, n)                                 \
  if (k < cap) words[k] = (int)(offsetof(ParamBlock, name) / 4); \
  ++k;
  ORT_PARAM_FIELDS(ORT_PARAM_OFFSET)
#undef ORT_PARAM_OFFSET
  if (k < cap) words[k] = (int)(sizeof(ParamBlock) / 4);
  return k;
}

#endif  // ORT_PARAM_BLOCK_CUH_
