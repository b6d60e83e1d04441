"""Host utilities."""

from .image import (write_png, read_png, slice_cubemap_cross,
                    load_cubemap_cross)
