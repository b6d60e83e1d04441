"""Benchmark presets matching the reference report's evaluation configs
(reference: OpenGL_RTGP_RayTracing.pdf section 8):

  baseline : 1 SPP, GI/AO off, TAA/SVGF off
  realistic: 1 SPP, GI/AO on, TAA on, SVGF off
  full     : 1 SPP, all on
  heavy    : 4 SPP, all on
"""

from __future__ import annotations

from ..params import RenderParams


def preset(name: str) -> RenderParams:
    base = RenderParams()
    if name == "baseline":
        return base.replace(spp_per_frame=1, enable_gi=0, enable_ao=0,
                            enable_taa=0, enable_svgf=0)
    if name == "realistic":
        return base.replace(spp_per_frame=1, enable_gi=1, enable_ao=1,
                            enable_taa=1, enable_svgf=0)
    if name == "full":
        return base.replace(spp_per_frame=1, enable_gi=1, enable_ao=1,
                            enable_taa=1, enable_svgf=1)
    if name == "heavy":
        return base.replace(spp_per_frame=4, enable_gi=1, enable_ao=1,
                            enable_taa=1, enable_svgf=1)
    raise ValueError(f"unknown preset {name!r}")


PRESETS = ("baseline", "realistic", "full", "heavy")
