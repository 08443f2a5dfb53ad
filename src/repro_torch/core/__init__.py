"""Core HOG + SVM detection math of the port (see repro_torch/__init__.py)."""
