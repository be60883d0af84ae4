"""Framework-free helpers: the bigint oracle, the wire codec and the loader
of the native pairing library (the port's own copies)."""
