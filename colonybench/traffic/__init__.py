"""Traffic kinds, one module each (``serve_generator``), and the traffic
mixes they read, one data file each (``<mix>.json``, whose ``kind`` names
the module)."""
