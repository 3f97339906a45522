"""Scale-out: sharded page-grid decode and row-group scans over devices and
torch.distributed ranks."""

from .mesh import PageGrid, build_page_grid, sharded_decode_step  # noqa: F401
from .scan import (  # noqa: F401
    column_stats,
    distributed_column_stats,
    mesh_reduce_stats,
    process_row_groups,
    scan_row_groups,
)
