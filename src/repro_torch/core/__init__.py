"""Waveform synthesis, mitigations, specs, the batched engine and the
Study surface."""
