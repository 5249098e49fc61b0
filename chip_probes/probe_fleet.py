"""Probe: a replica's start-up stages (two fresh processes one after the
other, then two side by side, through startup_probe.py), then phase 17
of chip_smoke alone. Run from the repo root on a machine with the card:
``python3 chip_probes/probe_fleet.py [--no-fleet]``."""
import os, subprocess, sys, time
from pathlib import Path
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import numpy as np
import torch
import chip_smoke as S
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.ops import _build
from hops_tpu_torch.ops import attention as A
from hops_tpu_torch.runtime.devices import card

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
card_line = card()
print(card_line, flush=True)
t = time.perf_counter(); _build.build(); print(f"build {time.perf_counter()-t:.1f} s", flush=True)
art = S.ROOT / "_smoke" / "artifact"
t = time.perf_counter()
params = random_params(**S.MODEL, seed=0)
save_lm_artifact(art, S.MODEL, params)
print(f"artifact {time.perf_counter()-t:.1f} s, {sum(f.stat().st_size for f in art.iterdir())/1e6:.0f} MB", flush=True)
probe = str(Path(__file__).parent / "startup_probe.py")
for i in range(2):
    t = time.perf_counter()
    r = subprocess.run([sys.executable, probe, str(art), str(REPO)], capture_output=True, text=True)
    print(f"--- startup probe {i}: wall {time.perf_counter()-t:.2f} s rc {r.returncode}\n{r.stdout}\n{r.stderr[-2000:]}", flush=True)
t = time.perf_counter()
ps = [subprocess.Popen([sys.executable, probe, str(art), str(REPO)], stdout=subprocess.PIPE, text=True) for _ in range(2)]
outs = [p.communicate()[0] for p in ps]
print(f"--- two concurrent probes: wall {time.perf_counter()-t:.2f} s", flush=True)
for o in outs:
    print([l for l in o.splitlines() if l.startswith("STAMPS")], flush=True)
if "--no-fleet" in sys.argv:
    sys.exit(0)
predictor = LMEnginePredictor(art, {"slots": 4})
rng = torch.Generator().manual_seed(1)
prompts = [torch.randint(0, S.MODEL["vocab_size"], (n,), generator=rng).tolist() for n in S.PROMPT_LENS]
instances = [{"prompt": p, "max_new_tokens": n, "temperature": 0.0} for p, n in zip(prompts, S.NEW_TOKENS)]
answers = predictor.predict(instances)
predictor.stop(); del predictor; torch.cuda.empty_cache()
t = time.perf_counter()
try:
    S.fleet_phase(A, torch, np, art, prompts, instances, answers, [1.0], dev, 0, card_line)
except AssertionError as e:
    print("ASSERT", e, flush=True)
print(f"fleet_phase wall {time.perf_counter()-t:.1f} s", flush=True)
