"""Training a ``transformer_lm`` configuration through the port's
``TransformerLM.fit`` on a ``'data'`` mesh of the cell's ``chips`` cards,
one process a card: the run's own process is rank 0 on ``cuda:0`` and
starts ranks 1.. on ``cuda:1``.. as ``python3
perfbench/drivers/lm_train_dp.py --rank r ...`` (a ``FileStore`` and the
cell's files under the run's scratch, NCCL; on the CPU, ``gloo``). Every
rank builds the same LM around the seeded weights with a ``MeshGroups`` of
``'data'`` and passes the same global batch (``rows`` x ``seq`` Markov
tokens) to ``fit``: each computes its ``rows / chips`` rows, and the step
all-reduces the loss and every gradient leaf before Adam.

Set-up runs the checked steps on every rank (rank 0 keeps the readings);
the window opens and closes on a barrier of every rank with each card
synchronised, and rank 0 decides before each step, on a host-side
(``gloo``) broadcast, whether the window goes on, so every rank runs the
same steps. Every rank runs the traced steps, rank 0 under the profiler.
Rank 0 then compares its checked steps with ``reference/gpt2.py`` on the
whole batch, in blocks of ``reference_rows`` rows.

Never a hang: the process group and every collective time out after
``timeout_s``; rank 0 watches the other ranks and ends the run (exit 3,
no result) as soon as one fails, joins them against a deadline at the
end and kills any rank left.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import checks, flops, training, weights  # noqa: E402
# the global batches (the same on every rank) and the reference on all
# of their rows are lm_train's
from perfbench.drivers.lm_train import batches, reference  # noqa: E402
from perfbench.harness import Outcome  # noqa: E402

JOIN_S = 120  # how long rank 0 waits for the other ranks at the end


def rank_rows(rows: int, world: int, rank: int) -> slice:
    """The rows of the global batch that ``rank`` computes (the port's
    ``'data'`` split: equal contiguous blocks in rank order)."""
    if rows % world:
        raise ValueError(f"{rows} rows do not split over {world} ranks")
    per = rows // world
    return slice(rank * per, (rank + 1) * per)


def counters(model, traffic, world, win, precision):
    """Per card: its rows' tokens and visible pairs a step."""
    mine = rank_rows(traffic["rows"], world, 0)
    rows, t = mine.stop - mine.start, traffic["seq"]
    pairs = rows * flops.causal_pairs(t)
    return {"model": model, "tokens_per_step": rows * t,
            "head_tokens_per_step": rows * t, "pairs_per_step": pairs,
            "window_steps": win["steps"], "window_s": win["seconds"],
            "peak": precision["peak"],
            "attn_bwd_call": {"heads": model["n_heads"],
                              "head_dim": model["d_model"] // model["n_heads"],
                              "pairs": pairs,
                              "peak": precision["attention_peak"]}}


class Rank:
    """One rank's process group, mesh and LM."""

    def __init__(self, cfg, traffic, world, seed, rank, store, device):
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.parallel.mesh import device_mesh
        from perfbench.programs import transformer_lm

        timeout = datetime.timedelta(seconds=traffic["timeout_s"])
        backend = "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
            backend = "nccl"
        dist.init_process_group(
            backend, store=dist.FileStore(str(store), world), rank=rank,
            world_size=world, timeout=timeout)
        self.dist = dist
        self.control = dist.new_group(backend="gloo", timeout=timeout)
        self.mesh = device_mesh((world,), ("data",))
        self.device = device
        model = cfg["model"]
        self.data = batches(traffic, model, seed, device)
        one = transformer_lm(model, seed, device,
                             weights.make(model, seed, device))
        self.lm = type(one)(one.cfg, device=device, params=one.params,
                            group=self.mesh)
        self.fit = lambda b: self.lm.fit(b[0], b[1])  # noqa: E731

    def barrier(self):
        training.sync(self.device)
        self.dist.barrier(group=self.control)

    def window(self, batch_at, seconds):
        """Steps on every rank until rank 0's clock passes ``seconds``;
        rank 0 decides before each step (a host broadcast)."""
        self.barrier()
        go = torch.zeros(1, dtype=torch.int32)
        t0 = time.perf_counter()
        losses = []
        while True:
            go[0] = int(time.perf_counter() - t0 < seconds)
            self.dist.broadcast(go, src=0, group=self.control)
            if not go[0]:
                break
            losses.append(self.fit(batch_at(len(losses))))
        self.barrier()
        wall = time.perf_counter() - t0
        vals = torch.as_tensor([float(x) for x in losses])
        return {"steps": len(losses), "seconds": wall,
                "nonfinite": int((~torch.isfinite(vals)).sum())}

    def close(self):
        self.dist.destroy_process_group()


def worker(args) -> int:
    """Ranks 1..: the same steps as rank 0 (the cell as rank 0 wrote it),
    no readings kept."""
    with open(args.cell) as f:
        cell = json.load(f)
    cfg, traffic = cell["config"], cell["traffic"]
    dev = (torch.device("cuda", args.rank) if cell["device"] == "cuda"
           else torch.device("cpu"))
    r = Rank(cfg, traffic, cell["world"], args.seed, args.rank, args.store,
             dev)
    k = traffic["checked_steps"]
    for b in r.data[:k]:
        r.fit(b)
    pool = r.data[k:]
    at = lambda i: pool[i % len(pool)]  # noqa: E731
    win = r.window(at, args.seconds)
    if args.trace:
        for i in range(traffic["trace_steps"]):
            r.fit(at(win["steps"] + i))
        r.barrier()
    r.close()
    return 0


class Ranks:
    """Ranks 1.. as child processes of rank 0, watched: the first to end
    with an error ends the run; :meth:`stop` joins them against a
    deadline and kills any left."""

    def __init__(self, ctx, store):
        cell = store.with_suffix(".cell.json")
        with open(cell, "w") as f:
            json.dump({"config": ctx.cell.config,
                       "traffic": ctx.cell.traffic,
                       "world": ctx.cell.chips,
                       "device": ctx.device.type}, f)
        cmd = [sys.executable, str(HERE), "--cell", str(cell),
               "--seed", str(ctx.seed), "--seconds", str(ctx.seconds),
               "--trace", str(int(ctx.trace)), "--store", str(store)]
        self.procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                       stdout=sys.stderr)
                      for r in range(1, ctx.cell.chips)]
        self.done = False
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.done:
            for p in self.procs:
                rc = p.poll()
                if rc not in (None, 0) and not self.done:
                    print(f"perfbench: rank process {p.pid} ended with "
                          f"{rc}; no result", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(3)
            time.sleep(0.5)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def stop(self, deadline_s: float = JOIN_S) -> None:
        end = time.monotonic() + deadline_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.done = True
        self.kill()
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank processes ended with {bad}")


def run(ctx) -> Outcome:
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    ctx.scratch.mkdir(parents=True, exist_ok=True)
    store = ctx.scratch / f"dp-store-{os.getpid()}-{time.time_ns()}"
    ranks = Ranks(ctx, store)
    try:
        r = Rank(cfg, traffic, ctx.cell.chips, ctx.seed, 0, store, dev)
        k = traffic["checked_steps"]
        prog = training.setup_steps(
            r.fit, r.data[:k], lambda: r.lm.opt["m"], lambda: r.lm.params,
            lambda: weights.make(cfg["model"], ctx.seed, dev))
        pool = r.data[k:]
        at = lambda i: pool[i % len(pool)]  # noqa: E731
        ctx.window_opened()
        win = r.window(at, ctx.seconds)
        summary = None
        if ctx.trace:
            summary = training.traced_slice(r.fit, at, win["steps"],
                                            traffic["trace_steps"],
                                            ctx.scratch)
            r.barrier()
        peak = training.peak_bytes(dev)
        data = r.data
        r.close()
        ranks.stop()
    finally:
        ranks.done = True
        ranks.kill()
        store.unlink(missing_ok=True)
        store.with_suffix(".cell.json").unlink(missing_ok=True)
    del r
    training.free_device(dev)
    ref = reference(cfg, traffic, ctx.seed, dev, data)
    return Outcome(
        e2e={"train_tokens_per_s":
             win["steps"] * traffic["rows"] * traffic["seq"] / win["seconds"]},
        attempted=win["steps"], failed=win["nonfinite"],
        checks=checks.training_checks(prog, ref, ctx.cell.limits["limits"]),
        counters=counters(cfg["model"], traffic, ctx.cell.chips, win,
                          cfg["precision"]),
        memory_peak_bytes=peak, trace=summary)


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--store", required=True)
    sys.exit(worker(ap.parse_args()))
