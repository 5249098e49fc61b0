"""Import torch once, then fork children that start an LM predictor:
``python3 zygote_probe.py ARTIFACT_DIR REPO_ROOT`` (probe_loop.py runs it)."""
import os, sys, time, json
t0 = time.perf_counter()
import torch
sys.path.insert(0, sys.argv[2])
t_imp = time.perf_counter() - t0
print(f"zygote import torch {t_imp:.2f} s", flush=True)
for i in range(2):
    r, w = os.pipe()
    tf = time.perf_counter()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        st = []
        c0 = time.perf_counter()
        from hops_tpu_torch.modelrepo import serving
        st.append(("import serving", time.perf_counter() - c0))
        torch.zeros(1, device="cuda")
        st.append(("cuda init", time.perf_counter() - c0))
        p = serving.LMEnginePredictor(sys.argv[1], {"slots": 4})
        torch.cuda.synchronize()
        st.append(("predictor", time.perf_counter() - c0))
        out = p.predict([{"prompt": list(range(1, 33)), "max_new_tokens": 4}])
        st.append(("first predict", time.perf_counter() - c0))
        p.stop()
        os.write(w, json.dumps(st).encode())
        os._exit(0)
    os.close(w)
    data = os.read(r, 65536)
    os.waitpid(pid, 0)
    print(f"child {i}: {data.decode()} wall {time.perf_counter() - tf:.2f} s", flush=True)
