"""File I/O: NetCDF, output streams, diagnostics, restarts, ancillaries."""
