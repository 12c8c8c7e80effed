"""Worker process for the port's two-process farm test.

    python tests/torch_distributed_worker.py RANK WORLD PORT

Launched twice by ``tests/test_torch_distributed.py`` (ranks 0 and 1),
each process adding 4 ``cpu`` slots to an 8-slot world mesh over gloo.
Exercises:

* ``parallel.init_distributed`` (explicit coordinator wiring, gloo);
* ``make_mesh`` over the global slot list;
* ``render_farm(mixdown=True)``: the mix bus's sum crosses processes (one
  ``all_reduce``), held to a local scan render of every voice within
  1e-4;
* ``render_farm`` per voice: each rank holds its own voices (their range
  in ``FarmResult.voices``), each within 1e-5 of its local scan render;
* ``batched_train_step(mesh=...)``: the gradients summed across ranks by
  one ``all_reduce``; the step equals the unsharded one within 1e-6.

Exit code 0 = every check passed on this rank.
"""

import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import srack_tpu_torch as stt  # noqa: E402
from srack_tpu_torch import parallel  # noqa: E402
from srack_tpu_torch.compiler import tree_leaves  # noqa: E402
from srack_tpu_torch.utils.train import (SoundMatcher,  # noqa: E402
                                         batched_train_step)

RANK, WORLD, PORT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]


def main():
    torch.set_num_threads(1)
    info = parallel.init_distributed(
        coordinator_address=f"localhost:{PORT}", num_processes=WORLD,
        process_id=RANK, backend="gloo", local_devices=["cpu"] * 4)
    assert info == {"process_id": RANK, "process_count": WORLD,
                    "global_devices": 4 * WORLD, "local_devices": 4}, info
    assert parallel.is_multiprocess()
    print(f"[p{RANK}] init: {info}", flush=True)

    mesh = parallel.make_mesh()
    assert mesh.devices.size == 4 * WORLD
    assert len(mesh.local_slots()) == 4

    cfg = stt.AudioConfig(sample_rate=4800, block_size=64, channels=1)
    p = stt.Patch(cfg)
    osc = p.add("Oscillator", val=0.0)
    p.connect(osc, "Sine", p.output, 0)
    v, n = 16, 256
    vals = np.linspace(-1.0, 0.5, v, dtype=np.float32)
    params = stt.stack_params([p.params() for _ in range(v)])
    params[osc.id]["val"] = torch.from_numpy(vals)

    def local(i):
        a, _, _ = stt.render(p, n, params={osc.id: {"val": vals[i]},
                                           p.output.id: {}},
                             engine="scan", device="cpu")
        return a.numpy()

    mixed, _, _ = parallel.render_farm(p, n, params=params, mesh=mesh,
                                       mixdown=True)
    want = np.zeros((1, n), np.float32)
    for i in range(v):
        want += local(i)
    err = float(np.abs(mixed.numpy() - want).max())
    print(f"[p{RANK}] mixdown err={err:.2e}", flush=True)
    assert err < 1e-4, err

    farm = parallel.render_farm(p, n, params=params, mesh=mesh)
    per = v // WORLD
    assert farm.voices == range(RANK * per, (RANK + 1) * per), farm.voices
    for j, i in enumerate(farm.voices):
        np.testing.assert_allclose(farm[0][j].numpy(), local(i), atol=1e-5)

    sv = stt.presets.subtractive_voice(cfg, gate_rate_oct=-1.0)
    compiled = stt.compile_patch(sv)
    ts = SoundMatcher(sv, n, device="cpu").init()
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    targets = torch.full((v, 1, n), 0.1)

    def fresh():
        return {m: {k: t.detach().clone().requires_grad_(True)
                    for k, t in pd.items()} for m, pd in ts["train"].items()}

    sharded = batched_train_step(compiled, sgd, n, fast=True, mesh=mesh,
                                 device="cpu")
    whole = batched_train_step(compiled, sgd, n, fast=True, device="cpu")
    t1, _, l1 = sharded(fresh(), ts["frozen"], None, targets, 2)
    t2, _, l2 = whole(fresh(), ts["frozen"], None, targets, 2)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l2)), (l1, l2)
    for a, b in zip(tree_leaves(t1), tree_leaves(t2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    print(f"[p{RANK}] train loss {float(l1):.6e} (whole {float(l2):.6e})",
          flush=True)
    torch.distributed.destroy_process_group()
    print(f"[p{RANK}] OK", flush=True)


if __name__ == "__main__":
    main()
