"""Built-in reaction rules of the port (`problems.py`)."""
