"""Time the stages of an LM replica's start in a fresh process:
``python3 startup_probe.py ARTIFACT_DIR REPO_ROOT`` (probe_fleet.py runs it)."""
import sys, time
t0 = time.perf_counter()
stamps = []
def st(what):
    stamps.append((what, time.perf_counter() - t0))
import torch
st("import torch")
sys.path.insert(0, sys.argv[2])
from hops_tpu_torch.modelrepo import serving
st("import serving")
torch.zeros(1, device="cuda")
st("cuda init")
import cProfile, pstats, io
pr = cProfile.Profile()
pr.enable()
m = serving.load_lm_artifact(sys.argv[1], torch.device("cuda", 0), ragged_decode=True)
torch.cuda.synchronize()
st("load_lm_artifact")
del m
p = serving.LMEnginePredictor(sys.argv[1], {"slots": 4})
torch.cuda.synchronize()
st("LMEnginePredictor")
pr.disable()
out = p.predict([{"prompt": list(range(1, 33)), "max_new_tokens": 4}])
st("first predict")
out = p.predict([{"prompt": list(range(1, 33)), "max_new_tokens": 4}])
st("second predict")
p.stop()
print("STAMPS", [(w, round(s, 3)) for w, s in stamps], flush=True)
s = io.StringIO()
pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
print(s.getvalue()[:6000])
