"""The sliding-Goertzel monitor: kernel A, its offline wrapper and the
float64 oracle."""
