"""Training jobs, one module per model family. `build(cfg, workload,
seed, device, session)` makes a `Job` through the program's own entry
points: `step(i)` takes one training step on batch i of the pool and
returns its loss (not waited for); `leaves()` names the parameters and
buffers; `first_grads()` reads the gradients of the first step back from
the optimizer's state."""
