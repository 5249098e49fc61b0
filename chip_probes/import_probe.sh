# How this machine's Python imports torch: bytecode settings, .pyc files
# beside torch's sources, and import times with and without a bytecode
# cache. Run from the repo root: bash chip_probes/import_probe.sh
python3 - <<'PY'
import os, sys, sysconfig, glob, time
print("flags dont_write_bytecode", sys.flags.dont_write_bytecode, "pycache_prefix", sys.pycache_prefix)
print({k: v for k, v in os.environ.items() if k.startswith("PYTHON")})
import importlib.util
spec = importlib.util.find_spec("torch")
d = os.path.dirname(spec.origin)
print("torch at", d, "writable", os.access(d, os.W_OK))
pyc = glob.glob(os.path.join(d, "**", "__pycache__", "*.pyc"), recursive=True)
py = glob.glob(os.path.join(d, "**", "*.py"), recursive=True)
print("py files", len(py), "pyc files", len(pyc), "sample", pyc[:2])
print("cpu count", os.cpu_count(), "affinity", len(os.sched_getaffinity(0)))
print(open("/proc/cpuinfo").read().split("model name")[1].split("\n")[0])
PY
for i in 1 2; do s=$(date +%s.%N); python3 -c "import torch"; e=$(date +%s.%N); echo "import torch $(echo "$e - $s" | bc) s"; done
for i in 1 2; do s=$(date +%s.%N); PYTHONPYCACHEPREFIX=_smoke/pyc python3 -c "import torch"; e=$(date +%s.%N); echo "import torch with pycache prefix $(echo "$e - $s" | bc) s"; done
python3 -X importtime -c "import torch" 2>&1 | sort -t'|' -k1 -n | tail -12
