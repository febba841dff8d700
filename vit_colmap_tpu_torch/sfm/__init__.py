"""Multi-view geometry: batched two-view primitives and the five-point
solver (the mapper's modules are not ported yet)."""
