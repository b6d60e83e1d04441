"""Application layer: state, input actions, main loop, headless CLI and
HTTP viewer.

Counterpart of `opengl_raytracing_tpu/app/` and of the reference's
`src/app/` + `src/io/` + picker parts of `src/ui/` (reference:
src/app/application.cpp, src/io/input.cpp, src/ui/gui.cpp:721-887).
"""

from .state import AppState
from .input import InputState, ACTIONS
from .application import Application
