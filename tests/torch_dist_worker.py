"""Worker of tests/test_torch_parallel.py: one rank of a multi-process gloo
job on the CPU that computes every case of one mesh shape through the port's
``parallel`` package and writes its results to an .npz.

Usage: python torch_dist_worker.py <rank> <world> <port> <channel> <time> <out_dir>

Every rank joins ``torch.distributed`` over tcp://localhost:<port> with one
torch thread, builds the (channel, time) mesh on the CPU and runs:

* ``chain8``: the flagship chain through ``ShardedRenderer.render``;
* ``dyn_cascade`` / ``dyn_comp`` (time > 1): the fused compressor+gate
  cascade and a lone compressor through ``dynspec`` on the burst signal;
* ``eq_chain`` / ``eq_low`` / ``eq_alone`` / ``eq_shelf`` (time > 1): the
  undecayed EQ through the renderer (which routes it to timescan) and
  through ``timescan`` on its own, and the JAX tests' decayed 3-band EQ and
  its low shelf alone through ``timescan``;
* ``lowcut`` (time == 4): a lowcut whose reach (639 samples) is longer
  than a one-block shard;
* ``local`` / meters (two ranks): ``dist.render_local_channels`` and
  ``dist.sharded_meters``;
* ``prog<k>_<chain>``: chain8 and the undecayed-EQ chain (and at time == 4
  the lowcut) through the renderer's rank program
  (``ShardedRenderer.steps``) played piece by piece, with dynspec's rounds
  on the device (k = 1, the route a capturable mesh captures) and read back
  each round (k = 0), the exchanges in the order they ran
  (``exchanges<k>_<chain>``) and dynspec's rounds (``rounds<k>_<chain>``);
* ``rounds<k>_<case>_<signal>`` / ``dynspec<k>_<case>_<signal>`` (time >
  1): the cascade and the lone compressor through ``dynspec`` on the burst
  signal and on a burst followed by silence, both routes;
* ``guard``: the k = 1 program of chain8 under a guard that refuses any
  read of a tensor's value on the host but the params' and the flags'.

Rank 0 writes the global results to ``<out_dir>/global.npz``; every rank
writes its own channels of ``local`` to ``<out_dir>/local_<rank>.npz``.
The inputs and chains are defined here and imported by the test.
"""

import os
import sys

import numpy as np

B = 512
CHANNELS = 8
N_BLOCKS = 16


def chain8_effects(pt, cfg, **kw):
    """The flagship chain, with the arguments of ``__graft_entry__._chain8``."""
    o = pt.ops
    return [o.lowcut(cfg, 120.0, **kw), o.highcut(cfg, 12000.0, **kw),
            o.eq3band_fft(cfg, 250.0, 2.0, 1500.0, -1.5, 6000.0, 2.5, **kw),
            o.compressor(cfg, -18.0, 0.6, 3.1, 30.1, **kw),
            o.gate(cfg, -45.0, 0.1, 3.1, 200.1, **kw),
            o.delay(cfg, 150.0, 2, **kw),
            o.tremolo(cfg, 0.3, 5.0, **kw), o.softclipper(cfg, 0.44, **kw)]


def eq_effects(pt, cfg, **kw):
    """An undecayed EQ (a low shelf at 0.3 Hz, -3 dB: the float64
    recurrence) between a FIR and a waveshaper."""
    o = pt.ops
    return [o.lowcut(cfg, 150.0, **kw), o.eq_band(cfg, "low", 0.3, -3.0, **kw),
            o.softclipper(cfg, 0.44, **kw)]


def eq3band_setting(pt, cfg, **kw):
    """The JAX package's own timescan setting (``tests/test_timescan.py``),
    a decayed 3-band EQ: run through ``timescan`` directly (a renderer takes
    its FIR)."""
    return pt.ops.eq3band(cfg, 200.0, 3.0, 1000.0, -2.0, 8000.0, 2.0, **kw)


def noise(channels: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((channels, n)) * 0.3, -0.99, 0.99
                   ).astype(np.float32)


def burst(channels: int, n: int, seed: int) -> np.ndarray:
    """Loud bursts over quiet noise: drives every automaton mode, including
    entries into a shard in ATTACK, HOLD and RELEASE."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((channels, n)) * 0.02).astype(np.float32)
    for start in range(0, n, 3000):
        seg = min(700, n - start)
        x[:, start:start + seg] += (rng.standard_normal((channels, seg))
                                    * 0.7).astype(np.float32)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def burst_then_silence(channels: int, n: int, seed: int) -> np.ndarray:
    """A loud burst, then silence: the gate's release (8,824 samples) runs
    across every time shard, the rounds' worst case."""
    rng = np.random.default_rng(seed)
    x = np.zeros((channels, n), np.float32)
    x[:, :1500] = np.clip(rng.standard_normal((channels, 1500)) * 0.7,
                          -0.99, 0.99)
    return x


def inputs() -> dict:
    n = B * N_BLOCKS
    return {"chain8": noise(CHANNELS, n, 0), "dyn": burst(2, n, 5),
            "eq": noise(2, n, 2), "lowcut": noise(2, 4 * B, 1),
            "dyn_silence": burst_then_silence(2, n, 6)}


REFUSED = frozenset({"item", "tolist", "__int__", "__bool__", "cpu", "numpy",
                     "__float__", "__index__", "__complex__"})


def _storages(node, found: set) -> set:
    """Storage addresses of every tensor in a params tree."""
    import dataclasses
    import torch
    if isinstance(node, torch.Tensor):
        found.add(node.untyped_storage().data_ptr())
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _storages(getattr(node, f.name), found)
    elif isinstance(node, (tuple, list)):
        for part in node:
            _storages(part, found)
    elif isinstance(node, dict):
        for part in node.values():
            _storages(part, found)
    return found


def host_read_guard(params, flag_lists):
    """A TorchFunctionMode that refuses a read of a tensor's value on the
    host (what a CUDA graph would freeze) but on the params' tensors and on
    the flags in ``flag_lists`` (lists the program appends its round and
    settle flags to before it reads them); counts the flags' reads."""
    from torch.overrides import TorchFunctionMode
    import torch

    class Guard(TorchFunctionMode):
        flag_reads = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in REFUSED and args \
                    and isinstance(args[0], torch.Tensor):
                ptr = args[0].untyped_storage().data_ptr()
                flags = {f.untyped_storage().data_ptr()
                         for lst in flag_lists for f in lst}
                if ptr in flags:
                    Guard.flag_reads += 1
                elif ptr not in allowed:
                    raise AssertionError(
                        f"the program read a tensor back: {name} on "
                        f"{tuple(args[0].shape)} {args[0].dtype}")
            return func(*args, **(kwargs or {}))

    allowed = _storages(params, set())
    return Guard()


def main() -> None:
    rank, world, port, channel, time_ = map(int, sys.argv[1:6])
    out_dir = sys.argv[6]

    import torch

    torch.set_num_threads(1)
    import pyaudiodsptools_tpu_torch as pt
    from pyaudiodsptools_tpu_torch.core import block as blk
    from pyaudiodsptools_tpu_torch.parallel import (ShardedRenderer, dist,
                                                    make_mesh)
    from pyaudiodsptools_tpu_torch.parallel.dynspec import \
        dynamics_offline_time_sharded
    from pyaudiodsptools_tpu_torch.parallel.timescan import \
        eq3band_offline_sharded

    dist.init_distributed(f"localhost:{port}", num_processes=world,
                          process_id=rank, backend="gloo")
    mesh = make_mesh(channel=channel, time=time_, device="cpu")
    cfg = pt.EngineConfig(44100, B)
    data = inputs()
    res = {}

    chain8 = pt.Chain(chain8_effects(pt, cfg, device="cpu"), device="cpu")
    r8 = ShardedRenderer(chain8, cfg, mesh)
    res["chain8"] = r8.render(data["chain8"]).numpy()

    def sharded(fn, sig):
        """fn on this rank's shard of ``sig``, every rank's output gathered
        back into the global signal."""
        local = r8.shard(blk.make_blocks(torch.from_numpy(sig), B))
        return blk.combine_blocks(r8.gather(fn(local))).numpy()

    if time_ > 1:
        comp = pt.ops.compressor(cfg, -18.0, 0.6, 3.1, 30.1, device="cpu")
        cascade = pt.Chain([comp, pt.ops.gate(cfg, -45.0, 0.1, 3.1, 200.1,
                                               device="cpu")],
                           device="cpu").exec_effects[0]
        for name, p in (("dyn_cascade", cascade.params),
                        ("dyn_comp", comp.params)):
            res[name] = sharded(
                lambda x: dynamics_offline_time_sharded(p, x, mesh),
                data["dyn"])

        eq_chain = pt.Chain(eq_effects(pt, cfg, device="cpu"), device="cpu")
        res["eq_chain"] = ShardedRenderer(eq_chain, cfg, mesh).render(
            data["eq"]).numpy()
        for name, eq in (("eq_low", eq_chain.exec_effects[1]),
                         ("eq_alone", eq3band_setting(pt, cfg, device="cpu")),
                         ("eq_shelf", pt.ops.eq_band(cfg, "low", 200.0, 3.0,
                                                     device="cpu"))):
            res[name] = sharded(
                lambda x: eq3band_offline_sharded(eq.params, x, mesh),
                data["eq"])

    if time_ == 4:
        low = pt.Chain([pt.ops.lowcut(cfg, 400.0, device="cpu")],
                       device="cpu")
        res["lowcut"] = ShardedRenderer(low, cfg, mesh).render(
            data["lowcut"]).numpy()

    if world == 2:
        mine = data["chain8"][dist.host_channel_slice(CHANNELS)]
        local = dist.render_local_channels(r8, mine).numpy()
        np.savez(os.path.join(out_dir, f"local_{rank}.npz"), local=local)
        shard = r8.render_shard(r8.shard(blk.make_blocks(
            torch.from_numpy(data["chain8"]), B)))
        meters = dist.sharded_meters(shard, mesh)
        res["meters"] = np.array([meters["peak"], meters["rms"]])

    from pyaudiodsptools_tpu_torch.kernels import graph_cond
    from pyaudiodsptools_tpu_torch.parallel import dynspec
    from pyaudiodsptools_tpu_torch.parallel.mesh import play

    def program(rend, sig, capturable):
        """The renderer's rank program on this rank's shard of ``sig``,
        played piece by piece: (global output, exchanges, rounds)."""
        local = rend.shard(blk.make_blocks(torch.from_numpy(sig), B))
        done = []
        with dynspec.recorded_rounds() as rounds:
            out = play(rend.steps(local, capturable), done)
        return (blk.combine_blocks(out).numpy(), np.array(done, dtype=str),
                np.array(dynspec.read_rounds(rounds), dtype=np.int64))

    eq8 = pt.Chain(eq_effects(pt, cfg, device="cpu"), device="cpu")
    progs = {"chain8": (r8, data["chain8"]),
             "eq_chain": (ShardedRenderer(eq8, cfg, mesh), data["eq"])}
    if time_ == 4:
        progs["lowcut"] = (ShardedRenderer(low, cfg, mesh), data["lowcut"])
    for name, (rend, sig) in progs.items():
        for k in (0, 1):
            (res[f"prog{k}_{name}"], res[f"exchanges{k}_{name}"],
             res[f"rounds{k}_{name}"]) = program(rend, sig, bool(k))
    if time_ > 1:
        for name, p in (("cascade", cascade.params), ("comp", comp.params)):
            for sig in ("dyn", "dyn_silence"):
                for k in (0, 1):
                    with dynspec.recorded_rounds() as rounds:
                        res[f"dynspec{k}_{name}_{sig}"] = sharded(
                            lambda x: play(dynspec.time_sharded_steps(
                                p, x, mesh, bool(k))), data[sig])
                    res[f"rounds{k}_{name}_{sig}"] = np.array(
                        dynspec.read_rounds(rounds), dtype=np.int64)

    local8 = r8.shard(blk.make_blocks(torch.from_numpy(data["chain8"]), B))
    with graph_cond.fixpoints() as settles, \
            dynspec.recorded_rounds() as rounds:
        guard = host_read_guard(chain8.params, [settles, rounds])
        try:
            with guard:
                play(r8.steps(local8, True))
            res["guard_error"] = np.array("")
        except AssertionError as exc:
            res["guard_error"] = np.array(str(exc))
    res["guard_flag_reads"] = np.array(guard.flag_reads)
    res["guard_flags"] = np.array([len(settles), len(rounds)])

    if rank == 0:
        np.savez(os.path.join(out_dir, "global.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
