"""Multi-GPU row-band rendering (see sharding.py and shardmap.py)."""

from .sharding import (make_mesh, render_frame_sharded, make_sharded_render_fn,
                       shard_image_rows)
