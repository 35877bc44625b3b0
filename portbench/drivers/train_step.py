"""One training job in a loop of steps: the driver of every traffic file
whose ``driver`` is ``train_step``.

Set-up builds the port's step (``repro_torch.train.step.make_train_step``,
as ``launch/train.py`` drives it: float32 master weights and AdamW state,
the configuration's compute type, its microbatches) and hands it weights
drawn on the device from the seed (``generators/lm_weights.py``).  It then
drives that same state through the traffic's ``checked_steps`` first steps
(batches ``0, 1, ...`` of ``generators/lm_batches.py``), which are the
warm-up, and reads from them what the reference checks: each step's loss,
each leaf's first gradient as the optimizer took it (``mu / (1 - beta1)``
after step 1), and each leaf's change after the last checked step (against
the leaf drawn again from the seed).  The window's units are the next
steps, each on batches no step has seen; a unit's work is its tokens.

Route check, per step: every launch of K7 on ``flash_swa_wgmma`` and every
backward on ``flash_swa_bwd_wgmma``; a step whose route falls back, or
whose loss is not finite, counts as failed.

``correct``: once the window has closed and the program's state is freed,
the plain float32 reference (``reference/danube.py``) follows the checked
steps from the same weights and batches, and three numbers are held to the
traffic's ``limits``: the relative gap of the first step's loss, and by the
worst leaf the gap between the program's and the reference's norms of the
first gradient and of the change, each against the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (Adam moves them by rounding alone).  The later steps' losses
are kept in :attr:`Driver.detail` and not compared: Adam's first update
moves every weight by about its learning rate whatever the gradient's size,
so where bf16 rounding flips a small gradient's sign that weight moves the
other way, and the later losses read the sum of those flips.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from unittest import mock

import torch

from portbench.harness import spec
from portbench.reference import danube as ref

#: The model keys the port's ``ModelConfig`` takes from the configuration.
_MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
               "vocab_size", "head_dim", "rope_theta", "sliding_window",
               "activation")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gaps(got: dict, want: dict, median: float) -> float:
    """The widest gap of ``got``'s norms from ``want``'s, each against the
    larger of ``want``'s norm and ``median``."""
    if set(got) != set(want):
        return float("inf")
    return max((abs(got[k] - want[k]) / max(want[k], median) for k in want),
               default=0.0)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.kernels.flash_swa import kernel as FK
        from repro_torch.train import step as T
        from repro_torch.train.optimizer import OptConfig, init_opt_state

        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.seed, self.traffic = seed, traffic
        self.model = config["model"]
        if self.model["family"] != "dense":
            raise spec.SpecError("train_step drives dense decoders only")
        self.weights = spec.generator("lm_weights")
        self.batches = spec.generator("lm_batches")
        self.launches = FK.LAUNCHES
        self.microbatches = int(config["microbatches"])
        self.batch_kw = dict(
            batch=int(config["global_batch"]), seq_len=int(traffic["seq_len"]),
            vocab=int(self.model["vocab_size"]),
            mean_doc_len=int(traffic["mean_doc_len"]),
            zipf_alpha=float(traffic["zipf_alpha"]), device=self.device)
        cfg = ModelConfig(name=config["name"], family="dense",
                          **{k: self.model[k] for k in _MODEL_KEYS},
                          **config["program"])
        self.opt = dict(traffic["optimizer"])
        self.step_fn = T.make_train_step(
            cfg, OptConfig(**self.opt), None,
            num_microbatches=self.microbatches,
            dtype=_DTYPES[config["precision"]["compute"]])
        t = time.perf_counter()
        self.params = self.weights.make(self.model, seed, self.device)
        self.opt_state = init_opt_state(self.params)
        self.init_s = time.perf_counter() - t
        self.next_batch = 0
        self.readings = {"loss": [], "grad": {}, "change": {}}
        t = time.perf_counter()
        for k in range(int(traffic["checked_steps"])):
            rec = self.run_unit()
            self.readings["loss"].append(float(rec["answer"]))
            if k == 0:
                self.readings["grad"] = self._first_grads()
        self.readings["change"] = self._changes()
        self.first_steps_s = time.perf_counter() - t

    def describe(self) -> str:
        return (f"weights drawn in {self.init_s:.3f} s; "
                f"{self.traffic['checked_steps']} checked steps in "
                f"{self.first_steps_s:.3f} s, losses {self.readings['loss']}")

    @torch.no_grad()
    def _first_grads(self) -> dict:
        b1 = float(self.opt["beta1"])
        return {path: float(m.double().norm()) / (1 - b1) for path, m in
                self.weights.leaves(self.opt_state["mu"])}

    @torch.no_grad()
    def _changes(self) -> dict:
        out = {}
        for path, p in self.weights.leaves(self.params):
            start = self.weights.leaf(self.model, self.seed, path,
                                      self.device)
            out[path] = float(start.sub_(p).double().norm())
            del start
        return out

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def run_unit(self) -> dict:
        before = dict(self.launches)
        t = time.perf_counter()
        batch = self.batches.batch_at(self.seed, self.next_batch,
                                      **self.batch_kw)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        self._sync()
        latency = time.perf_counter() - t
        self.next_batch += 1
        d = {k: self.launches[k] - before[k] for k in self.launches}
        route_ok = (not self.on_card
                    or (d["flash_swa"] > 0
                        and d["flash_swa_wgmma"] == d["flash_swa"]
                        and d["flash_swa_bwd"] > 0
                        and d["flash_swa_bwd_wgmma"] == d["flash_swa_bwd"]))
        tokens = self.batch_kw["batch"] * self.batch_kw["seq_len"]
        return {"latency_s": latency, "answer": metrics["loss"].detach(),
                "work": tokens, "route_ok": route_ok}

    def context(self) -> dict:
        """What the metric readers need of this cell's shapes."""
        return {"model": self.model, "batch": self.batch_kw["batch"],
                "seq_len": self.batch_kw["seq_len"]}

    def release(self) -> None:
        self.params = self.opt_state = self.step_fn = None

    def _follow(self, mm) -> dict:
        """The reference's readings of the checked steps, its products
        taken by ``mm``."""
        dec = ref.Decoder(self.weights.make(self.model, self.seed,
                                            self.device),
                          self.model, self.opt, mm)
        out = {"loss": [], "grad": {}, "change": {}}
        for k in range(int(self.traffic["checked_steps"])):
            batch = self.batches.batch_at(self.seed, k, **self.batch_kw)
            out["loss"].append(dec.loss_and_grads(batch, self.microbatches))
            norms = dec.adamw()
            if k == 0:
                out["grad"] = norms
        with torch.no_grad():
            for path, p in dec.stacked.items():
                start = self.weights.leaf(self.model, self.seed, path,
                                          self.device)
                out["change"][path] = float(start.sub_(p).double().norm())
                del start
        del dec
        if self.on_card:
            torch.cuda.empty_cache()
        return out

    def _reference(self) -> dict:
        if not hasattr(self, "_ref"):
            self._ref = self._follow(torch.matmul)
        return self._ref

    def compare(self, got: dict) -> dict:
        """The three numbers of ``got``'s readings against the reference
        (each step's and each leaf's gap kept in :attr:`detail`)."""
        want = self._reference()
        steps = [abs(g - w) / abs(w) for g, w in
                 zip(got["loss"], want["loss"])]
        if len(got["loss"]) != len(want["loss"]):
            steps = [float("inf")]
        median = statistics.median(want["grad"].values())
        moved = {k for k, v in want["grad"].items() if v >= 1e-3 * median}
        cmed = statistics.median(want["change"][k] for k in moved)
        self.detail = {
            "loss_steps": steps, "loss_ref": want["loss"],
            "grad": {k: gaps({k: got["grad"].get(k, float("inf"))},
                             {k: want["grad"][k]}, median)
                     for k in want["grad"]},
            "change": {k: gaps({k: got["change"].get(k, float("inf"))},
                               {k: want["change"][k]}, cmed)
                       for k in moved}}
        return {"first_loss_gap": steps[0],
                "grad_gap": gaps(got["grad"], want["grad"], median),
                "change_gap": max(self.detail["change"].values(),
                                  default=0.0)}

    def judge(self, records: list):
        numbers = self.compare(self.readings)
        limits = self.traffic["limits"]
        checks = [{"name": n, "value": v, "limit": float(limits[n])}
                  for n, v in numbers.items()]
        bad = [not (r["route_ok"] and bool(torch.isfinite(r["answer"])))
               for r in records]
        return checks, bad

    def control_reading(self) -> dict:
        return self.compare(self._follow(ref.fp8_mm))


@contextlib.contextmanager
def fault(name: str):
    """The program's step broken in one of the ways ``correct`` must
    catch: ``state_unchanged`` (the update leaves weights and state as they
    were), ``half_batch`` (the first half of each batch's rows alone, its
    mean taken), ``altered_answer`` (the loss off by 1%)."""
    from repro_torch.train import step as T
    orig_grads, orig_update = T.loss_and_grads, T.adamw_update

    def unchanged(params, grads, opt_state, cfg, **kw):
        return params, opt_state, {"grad_norm": torch.zeros(()),
                                   "lr": torch.zeros(())}

    def half(params, cfg, batch, n, dtype=torch.bfloat16, mesh=None):
        rows = batch["tokens"].shape[0] // 2
        return orig_grads(params, cfg, {k: v[:rows] for k, v in
                                        batch.items()}, max(n // 2, 1),
                          dtype, mesh)

    def altered(*args, **kw):
        loss, metrics, grads = orig_grads(*args, **kw)
        return loss, dict(metrics, loss=metrics["loss"] * 1.01), grads

    patches = {"state_unchanged": ("adamw_update", unchanged),
               "half_batch": ("loss_and_grads", half),
               "altered_answer": ("loss_and_grads", altered)}
    attr, fn = patches[name]
    with mock.patch.object(T, attr, fn):
        yield


FAULTS = ("state_unchanged", "half_batch", "altered_answer")
