"""The training loop (mic_tpu/train/trainer.py): state init or resume, the
train and eval steps, the epoch loop with logging to
``<output_dir>/metrics.jsonl``, eval (loss, and with ``gen_eval`` BLEU
from beam-search captions), train-state checkpoints every ``save_steps``
and at the end (``<output_dir>/checkpoints/<step>``, the newest
``save_total_limit`` kept), and a servable model directory
(``<output_dir>/model``, with tokenizer.json where the tokenizer saves).

The step runs the model from the bf16 shadow (train/shadow.py), the loss
through ops/fused_ce.py (on CUDA the two flash-CE kernels), autograd for
the gradients and the AdamW step in place.  Resume restores params,
moments, step, the dropout generator and the data position, so a resumed
run is bit-equal to an uninterrupted one.  ``fused_adamw=False`` runs
mic_tpu's optax chain (train/adamw_chain.py), ``remat="dots"`` saves the
layers' matrix products (nn/stacked.py), and ``profile_steps`` traces a
range of steps with torch.profiler into ``<output_dir>/profile``.

Data parallelism (mic_tpu's mesh with tp = 1) runs one process a device
over torch.distributed (parallel/distributed.py starts the group):
``dp`` is the world size (-1: all of it), the global batch is
``per_device_batch_size`` times it, and each rank loads its rows of every
global batch.  The loss is the global batch's (its token count summed over
the ranks, each rank's loss weighted by its share), its gradients summed in
bucketed all-reduces, and dropout masks are drawn for the global batch
(``GlobalBatchMasks``), so a dp run computes what one process does on the
whole batch.  ``fsdp=True`` also splits every master leaf, its AdamW
moments and its bf16 shadow over the ranks on the dim
parallel/sharding.py::param_specs gives it (leaves with none stay whole):
each step gathers the shadow (the float32 masters where a leaf has no
shadow, and the shared table, whose lookup reads float32 rows), takes the
gradients of the whole tree, reduce-scatters them and runs the optimizer on
this rank's parts.  Checkpoints keep the single-device format (rank 0
writes, the parts gathered first) and every rank restores and re-splits,
so a checkpoint moves between dp = 1, dp > 1 and fsdp.  Not ported yet,
and raising: tensor parallelism (tp > 1, ROADMAP A7b).

Every model family the port serves trains: the CLIP and ViT tower styles,
the pre-norm mBART and post-norm BART decoders, a tied or an untied LM
head.  An untied model's fused loss reads ``lm_head`` (train/shadow.py::
ce_table), the head it serves; mic_tpu's reads the shared embedding there.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
from mic_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from mic_tpu_torch.core.params import resolve_device, torch_dtype, tree_leaves, tree_map
from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.ops.fused_ce import fused_lm_loss
from mic_tpu_torch.ops.image_prep import maybe_preprocess
from mic_tpu_torch.parallel import distributed
from mic_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from mic_tpu_torch.parallel.sharding import (
    gather_tree, param_specs, shard_dim, shard_tree,
)
from mic_tpu_torch.train.fused_adamw import apply_gradients
from mic_tpu_torch.train.loss import label_smoothed_cross_entropy
from mic_tpu_torch.train.metrics import MetricLogger, StepTimer
from mic_tpu_torch.train.schedule import linear_warmup_linear_decay
from mic_tpu_torch.train.shadow import cast_shadow, ce_table, shadow_spec, shadowed_params
from mic_tpu_torch.train.state import (
    TrainState, checkpoint_tree, make_optimizer, moment_dtypes, restore_state,
)
from mic_tpu_torch.train.steps import count_params


def profile_range(spec: Optional[str]) -> Optional[tuple]:
    """``TrainConfig.profile_steps`` "a:b" -> (a, b): trace from before the
    step taken when ``a`` steps are done to after step ``b``; a missing b
    is a + 3 (mic_tpu/train/trainer.py).  None or "" -> None."""
    if not spec:
        return None
    a, _, b = spec.partition(":")
    return int(a), int(b or int(a) + 3)


class StepProfiler:
    """torch.profiler over a range of train steps (mic_tpu's jax.profiler
    trace): for ``steps`` = (a, b), started before the step taken when a
    steps are done, stopped after step b once the device is synchronized, a
    Chrome trace written under ``out_dir`` (CUDA activity on the card).
    Tracing changes no value the step computes."""

    def __init__(self, steps: Optional[tuple], out_dir: str, device: torch.device):
        self.steps, self.out_dir, self.device = steps, out_dir, device
        self.prof = None

    def before(self, step: int) -> None:
        if self.steps is None or step != self.steps[0]:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def after(self, step: int) -> None:
        if self.prof is not None and step == self.steps[1]:
            self.close()

    def close(self) -> None:
        """Stop a running trace and write it (also where the loop ends, or
        fails, inside the range)."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self.prof, self.steps = self.prof, None, None
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class GlobalBatchMasks:
    """The dropout masks of rank ``rank`` of ``ranks`` data-parallel
    processes: each drawn from ``generator`` (in the same state on every
    rank) for the global batch, whose leading dim is ``ranks`` times this
    rank's, and cut to this rank's rows.  So the masks do not depend on how
    the batch is split, as GSPMD draws mic_tpu's for the global array, and
    resume needs the one generator state.  nn/layers.py::keep_mask takes it
    in place of a generator."""

    def __init__(self, generator: torch.Generator, rank: int, ranks: int):
        self.generator, self.rank, self.ranks = generator, rank, ranks

    def keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        rows = shape[0]
        full = torch.rand((rows * self.ranks, *shape[1:]), generator=self.generator,
                          device=device) < keep
        return full[self.rank * rows:(self.rank + 1) * rows]

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def with_state(self, state: torch.Tensor) -> "GlobalBatchMasks":
        """A copy drawing from ``state`` (nn/stacked.py's recompute)."""
        copy = torch.Generator(device=self.generator.device)
        copy.set_state(state)
        return GlobalBatchMasks(copy, self.rank, self.ranks)


class _NoLogger:
    """The metric logger of ranks other than 0."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, model_config: CaptionerConfig, data_config: DataConfig,
                 train_config: TrainConfig, tokenizer: Optional[TokenizerBase] = None,
                 tokenizer_path: Optional[str] = None, device=None):
        tc = train_config
        if tc.tp != 1:
            raise NotImplementedError(
                f"tp={tc.tp}: tensor parallelism is not ported yet (ROADMAP A7b: the tied "
                "head's kernels would each see a vocab shard); data parallelism (dp) and "
                "fsdp are")
        self.mesh = make_mesh(dp=tc.dp, tp=1)
        self.rank, self.ranks = self.mesh.coords[DATA_AXIS], self.mesh.shape[DATA_AXIS]
        self.group = self.mesh.groups[DATA_AXIS]
        self.fsdp = tc.fsdp and self.ranks > 1
        self.profile_range = profile_range(tc.profile_steps)
        # tc.prng_impl picks the TPU's hardware RNG in mic_tpu; dropout here
        # always draws from torch's Philox generator, so it is ignored.
        self.mc, self.dc, self.tc = model_config, data_config, train_config
        if device is None and self.ranks > 1 and torch.cuda.is_available():
            device = distributed.local_device()
        self.device = resolve_device(device)
        self.dtype = torch_dtype(model_config.dtype)
        self.model = Captioner(model_config, remat=tc.remat if tc.remat != "none" else False)
        self.tokenizer = tokenizer or load_tokenizer(tokenizer_path)
        # one stream on every rank: the dropout masks are the global batch's
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.global_batch = tc.per_device_batch_size * self.ranks
        self.eval_batch = (tc.eval_batch_size or tc.per_device_batch_size) * self.ranks
        self._shadow_spec = None
        self._specs = None
        self.ckpt = TrainCheckpointManager(tc.output_dir, max_to_keep=tc.save_total_limit)

    # -- data -----------------------------------------------------------------

    def make_loaders(self):
        # the loader decodes images with PIL: imported only where data is read
        from mic_tpu_torch.data.dataset import CaptionDataset
        from mic_tpu_torch.data.loader import CaptionLoader

        dc = self.dc
        train_loader = CaptionLoader(
            CaptionDataset(dc.train_file, dc.images_dir, dc.lang_codes), self.tokenizer,
            self.global_batch, image_size=dc.decode_size, max_length=dc.max_seq_length,
            shuffle=True, drop_last=True, seed=dc.shuffle_seed, num_workers=dc.num_workers,
            lang_codes=dc.lang_codes, process_shard=(self.rank, self.ranks),
        )
        eval_loaders = {}
        if dc.validation_file:
            val_ds = CaptionDataset(dc.validation_file, dc.images_dir, dc.lang_codes)
            for lang, sub in val_ds.split_by_language().items():
                eval_loaders[lang] = CaptionLoader(
                    sub, self.tokenizer, self.eval_batch, image_size=dc.decode_size,
                    max_length=dc.max_seq_length, shuffle=False, drop_last=False, seed=0,
                    num_workers=0, lang_codes=dc.lang_codes,
                )
        return train_loader, eval_loaders

    def put_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch."""
        if self.ranks == 1:
            return batch
        per = len(batch["pixel_values"]) // self.ranks
        return {k: v[self.rank * per:(self.rank + 1) * per] for k, v in batch.items()}

    # -- steps ----------------------------------------------------------------

    def build(self, steps_per_epoch: int) -> None:
        tc = self.tc
        self.lr_fn = linear_warmup_linear_decay(
            tc.learning_rate, steps_per_epoch * tc.num_epochs, tc.warmup_steps)
        self.optimizer = make_optimizer(
            self.lr_fn, weight_decay=tc.weight_decay, b1=tc.adam_b1, b2=tc.adam_b2,
            eps=tc.adam_eps, max_grad_norm=tc.max_grad_norm, mu_dtype=tc.adam_mu_dtype,
            nu_dtype=tc.adam_nu_dtype, fused=tc.fused_adamw,
        )
        self._shadow_dtype = (self.dtype if tc.shadow_params and self.dtype != torch.float32
                              else None)
        if self.fsdp:
            self._specs = param_specs(init_params(self.mc, None, "meta"), 1,
                                      fsdp_axis_size=self.ranks)

    def init_state(self, params=None) -> TrainState:
        """The state at step 0: float32 ``params`` (e.g. from io/from_jax.py),
        or params drawn from ``tc.seed`` on the device; they come to require
        grad.  Under fsdp each rank keeps its parts.  Call ``build`` first."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
            params = init_params(self.mc, gen, self.device)
        if self.fsdp:
            params = shard_tree(params, self._specs, self.rank, self.ranks)
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        if self._shadow_dtype is not None:
            self._shadow_spec = shadow_spec(params, self._shadow_dtype)
        return TrainState.create(params, self.optimizer, self.generator, self._shadow_dtype)

    # -- state / resume --------------------------------------------------------

    def restore(self, manager: TrainCheckpointManager, step: Optional[int] = None):
        """(state, data meta) of ``manager``'s ``step`` (default: its latest)
        on this trainer's device, or (None, None) when it has none; under
        fsdp this rank's parts of it.  Call ``build`` first."""
        tree, meta = manager.restore(step, device=self.device)
        if tree is None:
            return None, None
        tc = self.tc
        mu_dtype, nu_dtype = moment_dtypes(tc.adam_mu_dtype, tc.adam_nu_dtype)
        state = restore_state(tree, init_params(self.mc, None, "meta"), self.generator,
                              mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                              shadow_dtype=None if self.fsdp else self._shadow_dtype,
                              fused=tc.fused_adamw)
        if self.fsdp:
            state = self._shard_state(state)
        if self._shadow_dtype is not None:
            self._shadow_spec = shadow_spec(state.params, self._shadow_dtype)
        return state, meta

    def _shard_state(self, state: TrainState) -> TrainState:
        """A whole state's parts on this rank, the shadow cast from them."""
        params = shard_tree(state.params, self._specs, self.rank, self.ranks)
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        opt = state.opt_state
        opt = type(opt)(opt.count, shard_tree(opt.mu, self._specs, self.rank, self.ranks),
                        shard_tree(opt.nu, self._specs, self.rank, self.ranks))
        shadow = None
        if self._shadow_dtype is not None:
            shadow = cast_shadow(params, shadow_spec(params, self._shadow_dtype),
                                 self._shadow_dtype)
        return TrainState(params, opt, state.step, state.generator, shadow)

    def init_or_resume(self, train_loader) -> TrainState:
        """Resume preference order: an explicit ``resume_from`` path (another
        run's output_dir, its checkpoints dir or a step dir), then this run's
        own latest checkpoint, then a fresh init.  The loader takes the data
        position saved with the checkpoint."""
        if self.tc.resume_from is not None:
            manager, step = TrainCheckpointManager.open(self.tc.resume_from)
            state, meta = self.restore(manager, step)
            if state is None:
                raise FileNotFoundError(f"--resume_from {self.tc.resume_from}: no checkpoint found")
        else:
            state, meta = self.restore(self.ckpt)
            if state is None:
                return self.init_state()
        if meta:
            train_loader.set_state(meta)
        return state

    def full_params(self, params):
        """``params`` whole: under fsdp every rank's parts gathered (every
        rank must call it), else ``params`` itself."""
        return gather_tree(params, self._specs, self.group) if self.fsdp else params

    def save(self, step: int, state: TrainState, data_meta: Optional[dict]) -> None:
        """A checkpoint of ``state`` in the single-device format: the parts
        gathered under fsdp, written by rank 0, every rank waiting for it."""
        tree = checkpoint_tree(state)
        if self.fsdp:
            opt = tree["opt_state"]
            tree = {**tree, "params": self.full_params(tree["params"]),
                    "opt_state": {"count": opt["count"], "mu": self.full_params(opt["mu"]),
                                  "nu": self.full_params(opt["nu"])}}
        if self.rank == 0:
            self.ckpt.save(step, tree, data_meta)
        self._barrier()

    def _barrier(self) -> None:
        if self.ranks > 1:
            torch.distributed.barrier(group=self.group)

    def _step_trees(self, state: TrainState):
        """(params, shadow) the step differentiates: the state's own, or under
        fsdp whole trees gathered for this step (the shadow where a leaf has
        one, else the float32 master; the loss's tables, the shared
        embedding and an untied ``lm_head`` kernel, both ways: their
        gradients reach the float32 masters as they do on one process),
        each leaf requiring grad."""
        if not self.fsdp:
            return state.params, state.shadow
        if state.shadow is None:
            params = gather_tree(state.params, self._specs, self.group)
            shadow = None
        else:
            sources = tree_map(lambda m, sh, cast: sh if cast else m, state.params, state.shadow,
                               self._shadow_spec)
            params = gather_tree(sources, self._specs, self.group)
            shadow = tree_map(lambda p: p, params)
            for outer, inner in (("shared", "embedding"), ("lm_head", "kernel")):
                if self._shadow_spec.get(outer, {}).get(inner):
                    params[outer] = {**params[outer], inner: gather_tree(
                        state.params[outer][inner], self._specs[outer][inner], self.group)}
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        return params, shadow

    def _sync_grads(self, grads: list):
        """The summed gradients of the global batch -> (grads, their global
        norm or None): all-reduced whole, or under fsdp reduce-scattered to
        this rank's parts (float32, as the masters) and their norm summed
        over the ranks."""
        if not self.fsdp:
            return distributed.all_reduce_sum(grads, self.group), None
        specs = [spec for _, spec in tree_leaves(self._specs)]
        out, whole = [], []
        for g, spec in zip(grads, specs):
            g = g.float()
            dim = shard_dim(spec)
            if dim is None:
                whole.append(g)
                out.append(g)
            else:
                out.append(distributed.reduce_scatter_dim(g, dim, self.group))
        summed = iter(distributed.all_reduce_sum(whole, self.group))
        out = [next(summed) if shard_dim(spec) is None else g for g, spec in zip(out, specs)]
        if self.tc.max_grad_norm is None:
            return out, None
        # squares of this rank's parts summed over the ranks, of whole leaves once
        parted = torch.zeros((), device=self.device)
        replicated = torch.zeros((), device=self.device)
        for g, spec in zip(out, specs):
            if shard_dim(spec) is None:
                replicated = replicated + torch.sum(torch.square(g))
            else:
                parted = parted + torch.sum(torch.square(g))
        torch.distributed.all_reduce(parted, group=self.group)
        return out, torch.sqrt(parted + replicated)

    def compute_loss(self, params, pixels, batch, generator=None, loss_mask=None, shadow=None):
        """The model from the shadow (or the params), then the loss; loss_mask
        defaults to the decoder attention mask."""
        tc, model = self.tc, self.model
        if loss_mask is None:
            loss_mask = batch["decoder_attention_mask"]
        cp = shadowed_params(params, shadow)
        if tc.fused_ce and tc.ce_chunk > 0:
            enc = model.encode(cp, pixels, generator)
            hidden = model.decode_hidden(cp, enc, batch["decoder_input_ids"],
                                         batch["decoder_attention_mask"], generator)
            table, table_cast = ce_table(params, shadow, self.dtype)
            return fused_lm_loss(
                hidden, table, params["final_logits_bias"], batch["labels"], loss_mask,
                tc.label_smoothing, tc.ce_chunk, table_cast, mode=tc.flash_ce,
                dl_max_rows=tc.dl_max_rows,
            )
        logits = model(cp, pixels, batch["decoder_input_ids"], batch["decoder_attention_mask"],
                       generator)
        return label_smoothed_cross_entropy(logits, batch["labels"], loss_mask,
                                            tc.label_smoothing)

    def train_step(self, state: TrainState, batch: dict):
        """One optimizer step on this rank's device batch -> (state, {"loss"
        (the global batch's, a device scalar), "learning_rate"}).  Params and
        moments change in place."""
        pixels = maybe_preprocess(batch["pixel_values"], self.mc.vision.image_size, self.dtype)
        params, shadow = self._step_trees(state)
        leaves = [leaf for _, leaf in tree_leaves(params)]
        rng = (state.generator if self.ranks == 1
               else GlobalBatchMasks(state.generator, self.rank, self.ranks))
        with torch.enable_grad():
            loss = self.compute_loss(params, pixels, batch, rng, shadow=shadow)
            objective = loss
            if self.ranks > 1:
                # each rank's mean over its tokens, weighted by its share of
                # the global batch's: the summed gradients are the global mean's
                ntok = batch["decoder_attention_mask"].sum().float()
                total = ntok.clone()
                torch.distributed.all_reduce(total, group=self.group)
                objective = loss * (ntok / total)
            grads = list(torch.autograd.grad(objective, leaves, allow_unused=True,
                                             materialize_grads=True))
        grad_norm = None
        if self.ranks > 1:
            grads, grad_norm = self._sync_grads(grads)
            loss = objective.detach().clone()
            torch.distributed.all_reduce(loss, group=self.group)
        lr = self.lr_fn(state.opt_state.count)
        out = apply_gradients(self.optimizer, state.params, self._tree_like(state.params, grads),
                              state.opt_state, shadow_spec=self._shadow_spec,
                              shadow_dtype=self.dtype, grad_norm=grad_norm)
        new_state = TrainState(out[0], out[1], state.step + 1, state.generator,
                               out[2] if len(out) == 3 else None)
        return new_state, {"loss": loss.detach(), "learning_rate": lr}

    @staticmethod
    def _tree_like(tree, leaves: list):
        """``leaves`` (in tree_leaves order) in ``tree``'s structure."""
        it = iter(leaves)
        ordered = {path: next(it) for path, _ in tree_leaves(tree)}

        def walk(node, path):
            if isinstance(node, dict):
                return {key: walk(value, path + (key,)) for key, value in node.items()}
            return ordered[path]

        return walk(tree, ())

    @torch.no_grad()
    def eval_step(self, params, batch: dict) -> dict:
        """Loss and token count of this rank's rows of an eval batch; with
        more than one rank, the global batch's (summed over the ranks)."""
        pixels = maybe_preprocess(batch["pixel_values"], self.mc.vision.image_size, self.dtype)
        loss_mask = batch["decoder_attention_mask"] * batch["loss_weight"][:, None]
        loss = self.compute_loss(params, pixels, batch, None, loss_mask=loss_mask)
        ntok = loss_mask.sum()
        if self.ranks > 1:
            # a rank whose rows are all padding has no tokens (its mean is 0/0)
            pair = torch.stack([torch.where(ntok > 0, loss * ntok, torch.zeros_like(loss)),
                                ntok.float()])
            torch.distributed.all_reduce(pair, group=self.group)
            loss, ntok = pair[0] / pair[1], pair[1]
        return {"loss": loss, "ntok": ntok}

    @torch.no_grad()
    def generate_step(self, params, pixels_u8, lang_token: int) -> torch.Tensor:
        """Beam-4 captions as training sees them: the PAD start token, then
        the language code forced at position 1."""
        pixels = maybe_preprocess(pixels_u8, self.mc.vision.image_size, self.dtype)
        out = self.model.generate(
            params, pixels, max_length=self.dc.max_seq_length, num_beams=4,
            decoder_start_token_id=self.mc.decoder.pad_token_id,
            forced_bos_token_id=lang_token,
        )
        return out.sequences

    # -- eval -----------------------------------------------------------------

    @staticmethod
    def _pad_to_multiple(batch: dict, multiple: int) -> tuple[dict, int]:
        """Pad a ragged eval batch to ``multiple`` by repeating its first
        example, with a per-example ``loss_weight`` zeroing the padding."""
        n = batch["pixel_values"].shape[0]
        pad = (-n) % multiple
        out = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) if pad else v
               for k, v in batch.items()}
        out["loss_weight"] = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        return out, n

    def evaluate(self, params, eval_loaders) -> dict:
        """Eval metrics with whole ``params`` (``full_params``): each rank
        runs its rows of every padded eval batch; losses and token counts are
        summed over the ranks and captions gathered in rank order."""
        # BLEU is needed only here
        from mic_tpu_torch.evals.bleu import bleu_1_to_4

        metrics = {}
        for lang, loader in eval_loaders.items():
            losses, ntoks, preds, refs = [], [], [], []
            loader.next_batch = 0
            for batch in loader.epoch_iterator(epoch=0):
                batch, n_real = self._pad_to_multiple(dict(batch), self.eval_batch)
                dev_batch = self.put_batch(self.local_rows(batch))
                m = self.eval_step(params, dev_batch)
                losses.append(float(m["loss"]))
                ntoks.append(float(m["ntok"]))
                if self.tc.gen_eval:
                    seqs = self.generate_step(params, dev_batch["pixel_values"],
                                              self.tokenizer.lang_code_to_id[lang]).cpu().numpy()
                    if self.ranks > 1:
                        seqs = np.concatenate(distributed.gather_objects(seqs, self.group))
                    preds.extend(self.tokenizer.batch_decode(seqs)[:n_real])
                    refs.extend(self.tokenizer.batch_decode(batch["labels"][:n_real]))
            if losses:
                metrics[f"{lang}/loss"] = float(np.average(losses, weights=ntoks))
            if preds:
                for k, v in bleu_1_to_4(preds, refs, lang[:2]).items():
                    metrics[f"{lang}/{k}"] = v
        return metrics

    # -- main loop ------------------------------------------------------------

    def train(self) -> TrainState:
        """The epoch loop; returns the last state (under fsdp, this rank's
        parts).  Rank 0 writes metrics, checkpoints and the model directory."""
        train_loader, eval_loaders = self.make_loaders()
        self.build(len(train_loader))
        state = self.init_or_resume(train_loader)
        logger = MetricLogger(self.tc.output_dir) if self.rank == 0 else _NoLogger()
        logger.log(0, {"param_count_m": count_params(init_params(self.mc, None, "meta")) / 1e6})
        timer = StepTimer()
        step = state.step
        profiler = StepProfiler(self.profile_range, os.path.join(self.tc.output_dir, "profile"),
                                self.device)
        try:
            while train_loader.epoch < self.tc.num_epochs:
                for batch in train_loader.epoch_iterator():
                    profiler.before(step)
                    state, metrics = self.train_step(state, self.put_batch(batch))
                    step += 1
                    profiler.after(step)
                    timer.tick()
                    if step % self.tc.logging_steps == 0:
                        scalars = {k: float(v) for k, v in metrics.items()}
                        scalars.update(timer.rates(self.global_batch))
                        logger.log(step, scalars, prefix="train")
                        timer.reset()
                    if eval_loaders and step % self.tc.eval_steps == 0:
                        logger.log(step, self.evaluate(self.full_params(state.params),
                                                       eval_loaders), prefix="eval")
                    if step % self.tc.save_steps == 0:
                        # the loader has not pulled the next batch yet: its
                        # position is that of the batch just trained on
                        self.save(step, state, train_loader.state())
            self.save(step, state, train_loader.state())
            if eval_loaders:
                logger.log(step, self.evaluate(self.full_params(state.params), eval_loaders),
                           prefix="eval")
        finally:
            profiler.close()
            train_loader.close()
            for loader in eval_loaders.values():
                loader.close()
            logger.close()
        # a servable model directory beside the train checkpoints
        params = self.full_params(state.params)
        if self.rank == 0:
            model_dir = os.path.join(self.tc.output_dir, "model")
            self.model.save_pretrained(model_dir, params)
            if hasattr(self.tokenizer, "save"):  # SimpleTokenizer's vocab travels too
                self.tokenizer.save(os.path.join(model_dir, "tokenizer.json"))
        self._barrier()
        return state
