"""Path resolution tolerant of the working directory
(reference: include/app/paths.h:22-48): assets resolve whether the process
runs from the repo root or a subdirectory.

A copy of `opengl_raytracing_tpu/utils/paths.py` that recognises the repo
by this package and its `models/` directory, so the port finds `models/`
and `cubemaps/` wherever it is checked out.
"""

from __future__ import annotations

import os

_REPO_MARKERS = ("opengl_raytracing_tpu_torch", "models")


def repo_root(start: str | None = None) -> str:
    d = os.path.abspath(start or os.getcwd())
    for _ in range(8):
        if all(os.path.exists(os.path.join(d, m)) for m in _REPO_MARKERS):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    # fallback: the package parent (this file is <root>/<pkg>/utils/paths.py,
    # so the repo root is three levels up)
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def resolve_path(rel: str) -> str:
    """Find `rel` relative to cwd, repo root, or package parent."""
    if os.path.isabs(rel) and os.path.exists(rel):
        return rel
    for base in (os.getcwd(), repo_root()):
        p = os.path.join(base, rel)
        if os.path.exists(p):
            return p
    return os.path.join(repo_root(), rel)


def resolve_dir(rel: str, create: bool = False) -> str:
    p = resolve_path(rel)
    if create:
        os.makedirs(p, exist_ok=True)
    return p
