"""Command-line launchers of the port."""
