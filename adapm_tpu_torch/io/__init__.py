"""Dataset IO for the port's apps."""
