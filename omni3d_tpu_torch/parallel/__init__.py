"""Data parallelism across processes: one process per GPU (DDP)."""
from .dist import (barrier, check_world, free_port, gather_objects, init_distributed,
                   mean_across_ranks, process_count, process_group_active, process_index,
                   run_spawned)

__all__ = ["barrier", "check_world", "free_port", "gather_objects", "init_distributed",
           "mean_across_ranks", "process_count", "process_group_active", "process_index",
           "run_spawned"]
