"""A two-process fleet of the port over `torch.distributed`'s gloo backend
on the CPU (a localhost rendezvous on a free port), 4 shards a process,
against one process holding the same 8 shards: `init_runtime` ->
`global_mesh` -> `host_local_to_global` -> a sharded-batched SGLD run and
a sharded SMC run (the counterpart of tests/test_runtime_multiprocess.py,
at its size: C=32 chains of D=3, S=5 samples).

Gates.  Every shard's generator depends only on its place on the global
mesh, and the cross-process gather is a concatenation (no reduction
crosses a process), so the fleet's SGLD positions and potentials and its
SMC particles, stage count and log Z equal the single process's bit for
bit (stricter than the JAX test's rtol 1e-4 for SMC, whose psum'd stage
scalars may round differently).  Each worker has a 120-s timeout of its
own.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from bayesian_ode_tpu_torch import parallel, samplers

idx, nproc, coord, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
if nproc > 1:
    r = parallel.init_runtime(coordinator_address=coord,
                              num_processes=nproc, process_id=idx,
                              backend="gloo")
else:
    r = parallel.init_runtime(device="cpu")
assert r.process_count == nproc, r
local = ["cpu"] * (8 // nproc)
mesh = parallel.global_mesh("chain", devices=local)
assert mesh.size == 8 and mesh.first_shard == idx * len(local)

C, D = 32, 3
pos_full = torch.linspace(-1.0, 1.0, C * D, dtype=torch.float32).reshape(C, D)
sl = parallel.process_slice(C, r)
pos = parallel.host_local_to_global(pos_full[sl], mesh, "chain")
kernel = samplers.sgld_batched(lambda q: 0.5 * (q * q).sum(-1), 1e-2)
positions, potentials = parallel.sample_chain_sharded_batched(
    kernel, pos, 0, num_samples=5, mesh=mesh, burn_in=2)

pmesh = parallel.global_mesh("particle", devices=local)
prior_full = torch.as_tensor(
    np.random.default_rng(7).normal(size=(C, D)).astype(np.float32))
prior = parallel.host_local_to_global(prior_full[sl], pmesh, "particle")
res = parallel.smc_sharded(
    1, lambda q: -2.0 * ((q - 0.5) ** 2).sum(-1),
    lambda q: -0.5 * (q * q).sum(-1), prior, pmesh, num_moves=2,
    max_stages=20)
np.savez(out + f".{idx}.npz", positions=positions.numpy(),
         potentials=potentials.numpy(), particles=res.particles.numpy())
with open(out + f".{idx}.json", "w") as f:
    json.dump({"lo": sl.start, "log_z": float(res.log_z),
               "num_stages": int(res.num_stages),
               "process_count": r.process_count}, f)
if nproc > 1:
    torch.distributed.destroy_process_group()
print("worker", idx, "ok", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_fleet(tmp_path, nproc, tag):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / f"out_{tag}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(nproc), coord, out],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return out


def _assemble(out, nproc, name, axis, shape):
    full = np.full(shape, np.nan, np.float32)
    for i in range(nproc):
        with open(out + f".{i}.json") as f:
            lo = json.load(f)["lo"]
        data = np.load(out + f".{i}.npz")[name]
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(lo, lo + data.shape[axis])
        full[tuple(sl)] = data
    assert not np.isnan(full).any(), f"{name}: unfilled rows"
    return full


def test_two_process_fleet_matches_one_process(tmp_path):
    C, D, S = 32, 3, 5
    single = _run_fleet(tmp_path, 1, "single")
    multi = _run_fleet(tmp_path, 2, "multi")
    for name, shape, axis in (("positions", (S, C, D), 1),
                              ("potentials", (S, C), 1)):
        np.testing.assert_array_equal(
            _assemble(single, 1, name, axis, shape),
            _assemble(multi, 2, name, axis, shape), err_msg=name)
    pa = _assemble(single, 1, "particles", 0, (C, D))
    pb = _assemble(multi, 2, "particles", 0, (C, D))
    np.testing.assert_array_equal(pa, pb)
    with open(single + ".0.json") as f:
        ja = json.load(f)
    with open(multi + ".0.json") as f:
        jb = json.load(f)
    with open(multi + ".1.json") as f:
        jc = json.load(f)
    assert ja["process_count"] == 1 and jb["process_count"] == 2
    assert ja["num_stages"] == jb["num_stages"] == jc["num_stages"]
    assert ja["log_z"] == jb["log_z"] == jc["log_z"]
