"""Multi-source relaxation (stage A of the staged builder) over the
min-plus sweep kernel; the blocked Floyd–Warshall waits for its
kernel."""
