"""Probe: disk write, fsync and read-and-SHA-256 rates, a forked replica
start (zygote_probe.py), and phase 17 (c) of chip_smoke alone with its
checkpoint I/O timed. Run from the repo root on a machine with the
card: ``python3 chip_probes/probe_loop.py``."""
import hashlib, os, subprocess, sys, time
from pathlib import Path
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import numpy as np
import torch
import chip_smoke as S
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.modelrepo.serving import save_lm_artifact
from hops_tpu_torch.ops import _build
from hops_tpu_torch.ops import attention as A
from hops_tpu_torch.runtime import checkpoint as CK, config
from hops_tpu_torch.runtime.devices import card
from hops_tpu_torch.telemetry.metrics import REGISTRY

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
card_line = card()
print(card_line, flush=True)
work = S.ROOT / "_smoke" / "fleet"
work.mkdir(parents=True, exist_ok=True)
buf = os.urandom(1 << 20) * 1100
t = time.perf_counter()
with open(work / "disk.bin", "wb") as f:
    f.write(buf)
    tw = time.perf_counter() - t
    os.fsync(f.fileno())
tf = time.perf_counter() - t - tw
t = time.perf_counter()
h = hashlib.sha256(); 
with open(work / "disk.bin", "rb") as f:
    while chunk := f.read(1 << 20):
        h.update(chunk)
print(f"disk: write 1.1 GB {tw:.2f} s, fsync {tf:.2f} s, read+sha256 {time.perf_counter()-t:.2f} s", flush=True)
x = torch.empty(275_000_000, device=dev)
t = time.perf_counter(); y = x.to("cpu", copy=True); print(f"D2H 1.1 GB pageable {time.perf_counter()-t:.2f} s", flush=True)
t = time.perf_counter(); torch.save({"x": y}, work / "ts.pt"); print(f"torch.save 1.1 GB {time.perf_counter()-t:.2f} s", flush=True)
t = time.perf_counter(); z = torch.load(work / "ts.pt", map_location="cpu", weights_only=True); print(f"torch.load 1.1 GB {time.perf_counter()-t:.2f} s", flush=True)
del x, y, z, buf
for p in ("disk.bin", "ts.pt"):
    (work / p).unlink()
t = time.perf_counter(); _build.build(); print(f"build {time.perf_counter()-t:.1f} s", flush=True)
art = S.ROOT / "_smoke" / "artifact"
save_lm_artifact(art, S.MODEL, random_params(**S.MODEL, seed=0))
r = subprocess.run([sys.executable, str(Path(__file__).parent / "zygote_probe.py"), str(art), str(REPO)],
                   capture_output=True, text=True)
print(r.stdout, r.stderr[-1500:], flush=True)

times = {}
def timed(name, fn):
    def w(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            times.setdefault(name, []).append(round(time.perf_counter() - t0, 3))
    return w
CK.CheckpointManager._finish_write = timed("finish_write (caller waits)", CK.CheckpointManager._finish_write)
CK.CheckpointManager._write_manifest = timed("manifest sha256", CK.CheckpointManager._write_manifest)
CK.CheckpointManager.verify_step = timed("verify sha256", CK.CheckpointManager.verify_step)
CK.CheckpointManager._load = timed("torch.load+place", CK.CheckpointManager._load)
CK._snapshot = timed("snapshot D2H", CK._snapshot)
torch.save = timed("torch.save (all)", torch.save)
os.fsync = timed("fsync (all)", os.fsync)
config.configure(workspace=str(work / "workspace"), project="chip_smoke")
t = time.perf_counter()
S.loop_closed(A, torch, np, work, dev, 0, card_line)
print(f"loop_closed wall {time.perf_counter()-t:.1f} s", flush=True)
for k, v in times.items():
    print(f"  {k}: n {len(v)} sum {sum(v):.2f} s {v}", flush=True)
for m in ("snapshot", "write", "restore"):
    h = REGISTRY.get(f"hops_tpu_checkpoint_{m}_seconds").labels()
    print(f"  metric {m}: n {h.count} sum {h.sum:.2f} s", flush=True)
