"""The frame function, the raster preview and the benchmark presets."""

from .pipeline import (FrameInputs, RenderState, FrameOutputs, render_frame,
                       make_render_fn)
from .presets import PRESETS, preset
from .raster import render_raster
