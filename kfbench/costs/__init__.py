"""Operations and bytes of a family's training step, from its shapes.

Each module has `costs(cfg, traffic) -> dict` for one rank's step:
`train_flops` (the model's FLOPs, the forward's three times, nothing
recomputed counted) and the least device seconds of the kernels whose
rooflines the metrics read (`<kernels>_bound_s`)."""
