"""Weight conversion into the torch port's state dicts."""
