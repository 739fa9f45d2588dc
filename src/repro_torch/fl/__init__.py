"""FL simulation engine of the port (`simulator`)."""
