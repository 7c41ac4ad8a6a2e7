"""Weight converters into the port."""
