"""Compressed data parallelism, the port against the JAX package.

Both packages train smollm-135m from the same weights on the same chain
data, each twice: the uncompressed train step, and the int8 error-feedback
compressed DP step over P ranks (two unless asked).  The JAX side is
``make_train_step`` and ``make_compressed_dp_train_step`` (under
``shard_map`` on P host devices, in a subprocess); the port's is
``make_train_step`` in this process and ``compressed_dp_run`` on a P-rank
gloo world.  The weights
are the port's own init, drawn on the host from seed 0 (what
``compressed_dp_run`` draws on any device), stacked into the JAX package's
tree.

``tests/test_torch_train_dist.py`` runs :func:`witness` on the smoke config.
At full width the run is minutes long on a CPU and is a script::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_dp_witness.py \\
        --full --n-layers 2 --global-batch 8 --seq-len 512 --steps 12 \\
        --out chiprun_out/dp_witness.json

which prints the four loss trajectories and each pair's largest step
difference, and writes them as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import torch

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ARCH = "smollm_135m"

_JAX_BODY = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.data import DataConfig, global_step_batch
from repro.launch import steps as steps_lib
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.optim import adamw, constant_schedule

a = json.loads(sys.argv[1])
cfg = get_smoke_config(a["arch"]) if a["smoke"] else get_config(a["arch"])
if a["n_layers"] is not None:
    cfg = dataclasses.replace(cfg, n_layers=a["n_layers"])
if a["dtype"] is not None:
    cfg = dataclasses.replace(cfg, dtype=a["dtype"])
dt = jnp.dtype(cfg.dtype)
flat = np.load(a["weights"])
params = {}
for key in flat.files:
    node = params
    *head, leaf = key.split("/")
    for k in head:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(flat[key], dtype=dt)
opt = adamw(constant_schedule(a["lr"]), weight_decay=0.0)
dcfg = DataConfig(vocab=cfg.vocab, seq_len=a["seq_len"],
                  global_batch=a["global_batch"], seed=a["data_seed"])
batches = [{k: jnp.asarray(v) for k, v in global_step_batch(dcfg, i).items()}
           for i in range(a["steps"])]
step = jax.jit(steps_lib.make_train_step(cfg, opt))
p, s, plain = params, opt.init(params), []
for b in batches:
    p, s, m = step(p, s, b)
    plain.append(float(m["loss"]))
del p, s
step_c, init_err = steps_lib.make_compressed_dp_train_step(cfg, opt)
p, s, err, comp = params, opt.init(params), init_err(params, a["ranks"]), []
with use_mesh(make_host_mesh(a["ranks"], 1)):
    fn = jax.jit(step_c)
    for b in batches:
        p, s, err, m = fn(p, s, err, b)
        comp.append(float(m["loss"]))
print("JAX-LOSSES " + json.dumps({"uncompressed": plain, "compressed": comp}))
"""


def port_config(smoke: bool, n_layers=None, dtype=None):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def _jax_flat(params) -> dict:
    """The port's tree as the JAX package's: ``blocks`` stacked over the
    layers, each leaf f32 numpy (exact for bf16), keyed by path."""
    from repro_torch.core import tree as tree_lib

    out = {}
    for key, leaf in tree_lib.flat(params).items():
        a = leaf.detach().float().cpu().numpy()
        parts = key.split("/")
        if parts[0] == "blocks":
            out.setdefault("/".join([parts[0]] + parts[2:]), []).append(a)
        else:
            out[key] = a
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def jax_losses(args: dict, weights_path: str) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{args['ranks']}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO_SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_BODY),
         json.dumps({**args, "weights": weights_path})],
        env=env, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    line = [s for s in out.stdout.splitlines() if s.startswith("JAX-LOSSES ")]
    return json.loads(line[-1][len("JAX-LOSSES "):])


def port_losses(args: dict, threads: int) -> dict:
    from repro_torch.core import make_executor
    from repro_torch.data import DataConfig, global_step_batch
    from repro_torch.distributed import comm
    from repro_torch.distributed.train_cases import (dp_weights,
                                                     run_train_cases)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adamw, constant_schedule

    cfg = port_config(args["smoke"], args["n_layers"], args["dtype"])
    opt = adamw(constant_schedule(args["lr"]), weight_decay=0.0)
    params = dp_weights(cfg, "cpu")
    state = opt.init(params)
    step = steps_lib.make_train_step(cfg, opt, executor=make_executor("torch"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args["seq_len"],
                      global_batch=args["global_batch"],
                      seed=args["data_seed"])
    plain = []
    for i in range(args["steps"]):
        batch = {k: torch.from_numpy(v)
                 for k, v in global_step_batch(dcfg, i).items()}
        params, state, m = step(params, state, batch)
        plain.append(float(m["loss"]))
    del params, state
    case = {k: args[k] for k in ("arch", "steps", "global_batch", "seq_len",
                                 "lr", "smoke", "n_layers", "data_seed",
                                 "dtype")}
    res = comm.run_world(run_train_cases, args["ranks"],
                         ([dict(op="compressed_dp", **case)], "cpu"),
                         threads=threads)
    return {"uncompressed": plain, "compressed": res[0][0]["losses"],
            "ranks_bitwise_equal": len({r[0]["digest"] for r in res}) == 1}


def witness(*, smoke: bool = True, n_layers=None, dtype=None,
            global_batch: int = 8,
            seq_len: int = 32, steps: int = 12, lr: float = 3e-3,
            data_seed: int = 17, ranks: int = 2, threads: int = 1) -> dict:
    """The four trajectories and each pair's largest step difference."""
    from repro_torch.distributed.train_cases import dp_weights, param_digest

    args = dict(arch=ARCH, smoke=smoke, n_layers=n_layers, dtype=dtype,
                global_batch=global_batch, seq_len=seq_len, steps=steps,
                lr=lr, data_seed=data_seed, ranks=ranks)
    weights = dp_weights(port_config(smoke, n_layers, dtype), "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "weights.npz")
        np.savez(path, **_jax_flat(weights))
        jax_l = jax_losses(args, path)
    port_l = port_losses(args, threads)

    def gap(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))

    return {"args": args, "weights_digest": param_digest(weights),
            "jax": jax_l, "port": port_l, "max_diff": {
        "port_vs_jax_uncompressed": gap(port_l["uncompressed"],
                                        jax_l["uncompressed"]),
        "port_vs_jax_compressed": gap(port_l["compressed"],
                                      jax_l["compressed"]),
        "jax_compressed_vs_uncompressed": gap(jax_l["compressed"],
                                              jax_l["uncompressed"]),
        "port_compressed_vs_uncompressed": gap(port_l["compressed"],
                                               port_l["uncompressed"])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: the smoke config)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--dtype", default=None,
                    help="the parameters' dtype (default: the config's)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data-seed", type=int, default=17)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--threads", type=int, default=2,
                    help="torch threads of each port rank")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    a = ap.parse_args(argv)
    torch.set_num_threads(a.ranks * a.threads)
    res = witness(smoke=not a.full, n_layers=a.n_layers, dtype=a.dtype,
                  global_batch=a.global_batch, seq_len=a.seq_len,
                  steps=a.steps, lr=a.lr, data_seed=a.data_seed,
                  ranks=a.ranks, threads=a.threads)
    for side in ("jax", "port"):
        for run in ("uncompressed", "compressed"):
            print(f"{side:4s} {run:12s} "
                  f"{[round(x, 4) for x in res[side][run]]}")
    print(json.dumps(res["max_diff"]))
    print("weights", res["weights_digest"])
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO_SRC)
    raise SystemExit(main())
