"""Host utilities: logging, image IO, path resolution, checkpointing,
frame timers."""

from .log import Logger, log
from .image import (write_png, read_png, read_image, slice_cubemap_cross,
                    load_cubemap_cross)
from .paths import resolve_path, resolve_dir
