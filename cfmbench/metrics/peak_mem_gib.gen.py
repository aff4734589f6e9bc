"""The allocator's peak over the window (`max_memory_allocated`), GiB."""

from cfmbench.readers import peak_mem_gib as read  # noqa: F401
