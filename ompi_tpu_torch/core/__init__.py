"""Core substrate of the port: config vars, MCA components, errors,
counters, logging, the device probe and the kernel build step."""
