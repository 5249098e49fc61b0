"""Phase 17 of chip_smoke alone, under the script's bytecode cache, with
the checkpoint metrics' totals. Run from the repo root on a machine
with the card: ``python3 chip_probes/probe_p17.py``."""
import os, sys, time
from pathlib import Path
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke as S
t = time.perf_counter()
print("pycache", S.bytecode_cache(os), flush=True)
import numpy as np
import torch
print(f"import torch {time.perf_counter()-t:.2f} s", flush=True)
from hops_tpu_torch.models.convert import random_params
from hops_tpu_torch.modelrepo.serving import LMEnginePredictor, save_lm_artifact
from hops_tpu_torch.ops import _build
from hops_tpu_torch.ops import attention as A
from hops_tpu_torch.runtime.devices import card
from hops_tpu_torch.telemetry.metrics import REGISTRY
import subprocess
for i in range(2):
    t = time.perf_counter(); subprocess.run([sys.executable, "-c", "import torch"]); print(f"child import torch {time.perf_counter()-t:.2f} s", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
card_line = card()
print(card_line, flush=True)
_build.build()
art = S.ROOT / "_smoke" / "artifact"
save_lm_artifact(art, S.MODEL, random_params(**S.MODEL, seed=0))
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
for m in ("snapshot", "write", "restore"):
    h = REGISTRY.get(f"hops_tpu_checkpoint_{m}_seconds").labels()
    print(f"  checkpoint {m}: n {h.count} sum {h.sum:.2f} s", flush=True)
