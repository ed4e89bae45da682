from .mesh import (  # noqa: F401
    coordination_barrier,
    initialize_distributed,
    process_count,
    process_index,
)
