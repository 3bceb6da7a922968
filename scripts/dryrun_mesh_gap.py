"""The dry run's per-device counts on a mesh, the port's beside the
reference's, at ``tests/test_dryrun_small.py``'s setting: ``deepseek-7b``
reduced, data 4 x model 4, B 8, S 64, M 2, bf16 params.

The port's come from ``repro_torch.launch.dryrun.dryrun_one`` on a fake
world of 16 ranks on ``meta`` (this process); the reference's from its
train step jitted with the rules' shardings on 16 host devices and read
by ``repro.launch.hloparse.analyze`` (a subprocess with
``--xla_force_host_platform_device_count=16``, on the CPU).  Prints one
JSON object with both (FLOPs a device; collective bytes a device by op).

    PYTHONPATH=src python3 scripts/dryrun_mesh_gap.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, M, DATA, MODEL = 8, 64, 2, 4, 4

REFERENCE = textwrap.dedent(f"""
    import json
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config, reduced
    from repro.launch import dryrun as dr, hloparse, mesh as mesh_lib
    from repro.models import lm as lm_lib
    from repro.sharding import rules as sh

    mesh = mesh_lib.make_host_mesh(data={DATA}, model={MODEL})
    cfg = reduced(get_config("deepseek-7b"))
    params = lm_lib.abstract_params(cfg, jnp.bfloat16)
    param_sh = sh.param_shardings(params, mesh, mode="train")
    batch = {{"tokens": jax.ShapeDtypeStruct(({B}, {S}), jnp.int32),
             "labels": jax.ShapeDtypeStruct(({B}, {S}), jnp.int32)}}
    batch_sh = sh.batch_shardings(batch, mesh)
    opt, train_step = dr.build_train_step(cfg, num_microbatches={M})
    opt_state = jax.eval_shape(opt.init, params)
    opt_sh = sh.opt_state_shardings(opt_state, mesh)
    with mesh_lib.set_mesh(mesh):
        compiled = jax.jit(train_step, in_shardings=(param_sh, opt_sh, batch_sh),
                           out_shardings=(param_sh, opt_sh,
                                          NamedSharding(mesh, P()))
                           ).lower(params, opt_state, batch).compile()
    stats = hloparse.analyze(compiled.as_text())
    coll = dict(stats["coll_by_op"], total=stats["coll_bytes"])
    print(json.dumps({{"hlo_flops_per_device": stats["dot_flops"],
                      "collective_bytes_per_device": coll}}))
""")


def port() -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.pipeline import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_shape
    SHAPES["dryrun_small"] = dict(seq_len=S, global_batch=B, kind="train")
    r = dryrun.dryrun_one("deepseek-7b", "dryrun_small", mesh_shape(DATA, MODEL),
                          save=False, force_microbatches=M,
                          cfg_override=reduced(get_config("deepseek-7b")))
    return {k: r[k] for k in ("hlo_flops_per_device", "flops_by_op",
                              "collective_bytes_per_device",
                              "collective_calls_per_device",
                              "model_flops_per_device")}


def reference() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    out = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                         text=True, env=env, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    print(json.dumps({"setting": {"arch": "deepseek-7b reduced", "mesh": [DATA, MODEL],
                                  "batch": B, "seq": S, "microbatches": M,
                                  "params": "bfloat16"},
                      "port": port(), "reference": reference()}, indent=1))


if __name__ == "__main__":
    main()
