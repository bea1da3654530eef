"""Systems under test, one module each, named by a configuration's "system":
each has `System(cfg, traffic, seed, device)` with `call(k)` (the timed
call) and `close()`, and `judge(cfg, traffic, seed, kept, device)`."""
