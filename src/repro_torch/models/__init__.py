"""The LM substrate of the port, dense family (see models/model.py)."""
