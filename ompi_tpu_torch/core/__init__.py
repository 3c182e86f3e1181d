"""Core substrate of the port: config vars, MCA components, errors,
counters, logging, the device probe, the kernel build step, requests,
the progress engine, info objects and attributes."""
