"""Traffic generators: each turns a workload's traffic parameters, the
configuration and a seed into the pool of batches one rank trains on,
staged on the device. The same seed gives the same pool."""
