"""Developer tooling: the static analyzer (`check.py`, `kfcheck/`) and
runtime debug instrumentation (lockwatch, protowatch).

Port of `kungfu_tpu/devtools/__init__.py`. The analyzer scans the port's
own tree: ``python -m kungfu_tpu_torch.devtools.check`` is its gate.

Nothing here is imported by the training path unless the operator asks
for it: `kungfu_tpu_torch/__init__` imports lockwatch only under a truthy
`KF_DEBUG_LOCKS`, and a host session imports protowatch only under a
truthy `KF_DEBUG_PROTOCOL`.
"""
