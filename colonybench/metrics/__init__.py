"""Per-layer metric readers, one file each, named as the metric: ``read(run)``
returns the metric's value from a run's record, or None where it finds
nothing to read. ``kernels/<kernel>.json`` names a custom op of the port
and the device kernels that run it, which the roofline readers attribute."""
