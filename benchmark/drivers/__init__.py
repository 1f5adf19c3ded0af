"""Cell drivers, one module each, found by the `driver` key of a
configuration's file. A driver's `Cell(config, traffic, seed, device,
control=False)` has `batch`, `setup()`, `tick()` (one tick of the timed
path, no host sync), `quality()`, `check()` -> [(name, value, limit)],
`layers()` (the spans of a traced window) and `kernels()` (role -> (name
pattern, work a launch))."""
