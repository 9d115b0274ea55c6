#!/usr/bin/env python3
"""What a process of chip_smoke.py pays before its first step, on one CUDA
card's host: a worker's imports with and without chip_smoke's shared
bytecode cache, and the seed-0 ResNet-50 (`init_resnet`'s draw on the
CPU, moved to the card) against loading a copy of it saved to a file.

    python3 chip_startup_probe.py

Each case runs alone (three times in a row) and as four processes at once,
as a world of chip_smoke starts them, in fresh interpreters timed from the
outside. Prints one JSON line a case, then the card's name and power limit.
Needs the card; writes only under build/."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "startup_probe"
# what every ResNet worker of chip_smoke imports before its first step
IMPORTS = ("import torch, numpy; import kungfu_tpu_torch.api, kungfu_tpu_torch.peer, "
           "kungfu_tpu_torch.torch, kungfu_tpu_torch.models.resnet")
DRAW = ("import time, torch; from kungfu_tpu_torch.models import resnet as r; "
        "torch.zeros(1, device='cuda').sum().item(); t = time.perf_counter(); "
        "m = r.init_resnet(r.resnet50(1000), torch.Generator().manual_seed(0), 'cuda'); "
        "torch.cuda.synchronize(); print(time.perf_counter() - t)")
SAVED = OUT / "resnet50_seed0.pt"
SAVE = ("import torch; from kungfu_tpu_torch.models import resnet as r; "
        "m = r.init_resnet(r.resnet50(1000), torch.Generator().manual_seed(0), 'cpu'); "
        f"torch.save(m.state_dict(), {str(SAVED)!r})")
LOAD = ("import time, torch; from kungfu_tpu_torch.models import resnet as r; "
        "torch.zeros(1, device='cuda').sum().item(); t = time.perf_counter(); "
        f"s = torch.load({str(SAVED)!r}, map_location='cuda'); "
        "m = r.resnet50(1000).to('cuda', memory_format=torch.channels_last); "
        "m.load_state_dict(s); torch.cuda.synchronize(); print(time.perf_counter() - t)")
TURNS, WORLD = 3, 4


def _env(cache: Path | None) -> dict:
    """The host's own environment (`cache` None), or chip_smoke's: bytecode
    written and read under `cache`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPYCACHEPREFIX"}
    if cache is not None:
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        env["PYTHONPYCACHEPREFIX"] = str(cache)
    return env


def _batch(n: int, code: str, env: dict) -> list:
    """Start n interpreters at once; each one's seconds from start to exit,
    and what it printed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(n)]
    out = []
    for p in procs:
        text, _ = p.communicate(timeout=600)
        if p.returncode:
            raise SystemExit(f"probe: {code!r} exited {p.returncode}")
        out.append({"s": time.perf_counter() - t0, "printed": text.strip()})
    return out


def _case(name: str, code: str, env: dict, inner: bool = False) -> dict:
    """TURNS runs alone, then WORLD at once; `inner`: the seconds the
    process printed (the timed call alone) instead of its whole life."""
    pick = (lambda r: float(r["printed"])) if inner else (lambda r: r["s"])
    alone = [pick(_batch(1, code, env)[0]) for _ in range(TURNS)]
    world = [pick(r) for r in _batch(WORLD, code, env)]
    rec = {"case": name, "alone_s": alone, "world_s": world,
           "alone_median_s": sorted(alone)[TURNS // 2], "world_max_s": max(world)}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    cache = OUT / "pycache"
    host = _env(None)
    print(json.dumps({"host_env": {"PYTHONDONTWRITEBYTECODE":
                                   os.environ.get("PYTHONDONTWRITEBYTECODE"),
                                   "cores": os.cpu_count()}}), flush=True)
    _case("imports, the host's environment", IMPORTS, host)
    first = _batch(1, IMPORTS, _env(cache))[0]["s"]  # fills the cache
    print(json.dumps({"case": "imports, filling the cache", "s": first}), flush=True)
    _case("imports, the cache warm", IMPORTS, _env(cache))
    # the draw against a saved copy of it
    warm = _env(cache)
    _batch(1, SAVE, warm)
    _case("seed-0 draw (init_resnet, to the card)", DRAW, warm, inner=True)
    _case("seed-0 load (torch.load of the saved draw, to the card)", LOAD, warm, inner=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
