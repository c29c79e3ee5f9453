"""Command-line launchers of the port (``launch.serve``)."""
