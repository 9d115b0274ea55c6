"""Developer tooling: runtime debug instrumentation (lockwatch, protowatch).

Port of `kungfu_tpu/devtools/__init__.py`, for what the port has (the
static analyzer `check.py` with `kfcheck/` is not ported yet).

Nothing here is imported by the training path unless the operator asks
for it: `kungfu_tpu_torch/__init__` imports lockwatch only under a truthy
`KF_DEBUG_LOCKS`, and a host session imports protowatch only under a
truthy `KF_DEBUG_PROTOCOL`.
"""
