"""The training loop, counterpart of `uformer_tpu/train/trainer.py`
(reference `train/train_denoise.py` and `train_motiondeblur.py`).

The reference's protocol: warmup + cosine (or StepLR) stepped per epoch,
Charbonnier loss, MixUp after epoch 5 (denoising only), validation 4x per
epoch with best-PSNR checkpointing, model_latest every epoch,
model_epoch_N every `checkpoint` epochs, resume from model_latest, and the
reference's text log. One train step (`make_train_step`) at the model's
dtype over float32 master weights, through the kernels on the card (their
plain versions with `attn_backend="jnp"`); batches reach the card through
`prefetch_to_device`; the loss is summed on the card and read once an
epoch. One generator, seeded with `opt.seed`, draws MixUp and DropPath,
and restarts from the seed on resume, as the JAX package's PRNGKey does;
fresh weights are drawn from the same seed.

Data-parallel (`opt.mesh_data` N > 1, over the process group of N ranks
that the CLI starts; `uformer_tpu/train/trainer.py:64-300`): every rank
loads only its rows of each global batch (the same seeded order), the
step runs under DistributedDataParallel (`make_train_step(mesh=...)`),
the epoch's loss sum is all-reduced once an epoch, validation runs
replicated on every rank over the whole set, as JAX's does, rank 0 alone
logs and writes `.pth` files, resume reads the file on every rank, and
`fit` ends with the weights' crc32 compared across ranks and a barrier.
Kept from the JAX package as they are (ROADMAP.md port queue 1 item 2):
no validation sweep before training.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, Iterable

import torch
import torch.distributed as dist

from uformer_tpu_torch.config import (
    Options,
    check_supported,
    runs_plain,
    torch_dtype,
)
from uformer_tpu_torch.convert import load_checkpoint as load_weights
from uformer_tpu_torch.data.datasets import (
    batch_iterator,
    get_training_data,
    get_validation_data,
    get_validation_deblur_data,
    prefetch_to_device,
)
from uformer_tpu_torch.eval.metrics import batch_psnr
from uformer_tpu_torch.eval.padding import pad_to_multiple, unpad
from uformer_tpu_torch.models.registry import get_arch
from uformer_tpu_torch.parallel.mesh import make_mesh, verify_replicated
from uformer_tpu_torch.parallel.multihost import (
    local_batch_range,
    rank_device,
)
from uformer_tpu_torch.train.checkpoints import (
    checkpoint_path,
    load_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from uformer_tpu_torch.train.schedules import (
    step_lr_schedule,
    warmup_cosine_schedule,
)
from uformer_tpu_torch.train.train_step import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)


class Trainer:
    def __init__(self, opt: Options):
        check_supported(opt)
        self.opt = opt
        self.device = torch.device(opt.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {opt.device}: torch.cuda.is_available() is false "
                f"(the trainer never falls back to the CPU; device 'cpu' "
                f"runs the kernels' plain versions)")
        self.mesh = None
        if (opt.mesh_data or 1) > 1:
            self.device = rank_device(opt.device)
            self.mesh = make_mesh(opt.mesh_data, opt.mesh_model,
                                  self.device)
        # one writer of logs and checkpoints, as in JAX and the reference
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.dtype = torch_dtype(opt)
        self.plain = runs_plain(opt)
        self.model = self._seeded_model().to(self.device)
        self.log_dir = os.path.join(opt.save_dir, opt.mode,
                                    opt.arch + opt.env)
        self.model_dir = os.path.join(self.log_dir, "models")
        if self.is_main:
            os.makedirs(self.model_dir, exist_ok=True)
        ts = datetime.datetime.now().isoformat()
        self.logname = os.path.join(self.log_dir, ts + ".txt")
        self.log(str(opt))
        if self.plain:
            self.log("attn_backend jnp: every kernel runs its plain "
                     "PyTorch version")

    def log(self, msg: str):
        if not self.is_main:
            return
        print(msg)
        with open(self.logname, "a") as f:
            f.write(msg + "\n")

    def _seeded_model(self):
        """The model with weights drawn from opt.seed (torch's default
        initialisers), the process's global RNG left as it was."""
        opt = self.opt
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(opt.seed)
            return get_arch({
                "arch": opt.arch, "embed_dim": opt.embed_dim,
                "train_ps": opt.train_ps, "dd_in": opt.dd_in,
                "win_size": opt.win_size, "dtype": self.dtype,
                "use_checkpoint": opt.use_checkpoint})

    # ------------------------------------------------------------------

    def build(self, steps_per_epoch: int):
        opt = self.opt
        if opt.warmup:
            sched = warmup_cosine_schedule(
                opt.lr_initial, opt.nepoch, steps_per_epoch,
                opt.warmup_epochs)
        else:
            sched = step_lr_schedule(opt.lr_initial, steps_per_epoch,
                                     opt.step_lr)
        mixup_after = 5 if opt.mode == "denoising" else None
        self.train_step = make_train_step(
            self.model, mixup_after_epoch=mixup_after,
            steps_per_epoch=steps_per_epoch, plain=self.plain,
            mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, plain=self.plain)
        self.sched = sched
        self.steps_per_epoch = steps_per_epoch

    def init_state(self, resume: bool = False) -> TrainState:
        """The train state at the start of `fit`: from model_latest.pth
        (weights, AdamW state, step) with resume, else from
        opt.pretrain_weights where that file exists, else the seeded
        weights; a fresh AdamW in the last two cases."""
        opt = self.opt
        optimizer = make_optimizer(self.model.parameters(), self.sched,
                                   weight_decay=opt.weight_decay,
                                   grad_clip=opt.grad_clip)
        start_epoch, step = 1, 0
        if resume:
            latest = checkpoint_path(self.model_dir, "model_latest")
            ckpt = load_checkpoint(latest)
            self.model.load_state_dict(ckpt["state_dict"])
            optimizer.load_state_dict(ckpt["optimizer"])
            # a checkpoint without the step field: derive it from the epoch
            step = int(ckpt.get("step", int(ckpt["epoch"])
                                * self.steps_per_epoch))
            start_epoch = int(ckpt["epoch"]) + 1
            self.log(f"Resume from {latest} at epoch {start_epoch} "
                     f"(step {step})")
        elif opt.pretrain_weights and os.path.exists(opt.pretrain_weights):
            load_weights(self.model, opt.pretrain_weights)
            self.log(f"Loaded pretrained weights {opt.pretrain_weights}")
        else:
            self.model.load_state_dict(self._seeded_model().state_dict())
        self.start_epoch = start_epoch
        return TrainState(self.model, optimizer, step)

    # ------------------------------------------------------------------

    def validate(self, state: TrainState,
                 val_batches: Iterable[Dict[str, torch.Tensor]]) -> float:
        """Mean PSNR over the val set (reference protocol: clamp,
        batch_PSNR summed then divided by the image count,
        train_denoise.py:188-202). Images of any size are padded to a
        multiple of win_size * 16 and unpadded after the forward, as the
        test scripts do (reference test/test_sidd.py:106)."""
        factor = self.opt.win_size * 16
        total, count = 0.0, 0
        for batch in val_batches:
            inp, orig_hw = pad_to_multiple(batch["input"], factor)
            restored = unpad(self.eval_step(inp), orig_hw)
            total += float(batch_psnr(restored, batch["target"],
                                      average=False))
            count += batch["input"].shape[0]
        return total / max(count, 1)

    def fit(self, train_dataset=None, val_dataset=None):
        opt = self.opt
        if train_dataset is None:
            train_dataset = get_training_data(
                opt.train_dir, {"patch_size": opt.train_ps})
        if val_dataset is None:
            if opt.mode == "deblurring":
                val_dataset = get_validation_deblur_data(
                    opt.val_dir, {"patch_size": opt.val_ps})
            else:
                val_dataset = get_validation_data(opt.val_dir)

        steps_per_epoch = max(len(train_dataset) // opt.batch_size, 1)
        self.build(steps_per_epoch)
        state = self.init_state(resume=opt.resume)
        local_range = None
        if self.mesh is not None:
            local_range = local_batch_range(opt.batch_size, self.mesh.group)
            self.log(f"data-parallel: {self.mesh.size} ranks, local batch "
                     f"rows [{local_range[0]}, "
                     f"{local_range[0] + local_range[1]})")
        eval_now = max(steps_per_epoch // 4, 1)
        best_psnr, best_epoch, best_iter = 0.0, 0, 0
        generator = torch.Generator(device="cpu").manual_seed(opt.seed)

        def val_batches():
            for i in range(len(val_dataset)):
                gt, noisy = val_dataset[i][0], val_dataset[i][1]
                yield {"input": torch.from_numpy(noisy[None].copy())
                       .to(self.device),
                       "target": torch.from_numpy(gt[None].copy())
                       .to(self.device)}

        self.log(f"===> Start Epoch {self.start_epoch} End Epoch {opt.nepoch}")
        for epoch in range(self.start_epoch, opt.nepoch + 1):
            t0 = time.time()
            # summed on the card: a float(loss) here would make the host
            # wait for every step; read once an epoch below
            epoch_loss = torch.zeros((), dtype=torch.float32,
                                     device=self.device)
            it = batch_iterator(train_dataset, opt.batch_size, shuffle=True,
                                seed=opt.seed + epoch,
                                num_threads=opt.workers,
                                local_range=local_range)
            for i, batch in enumerate(prefetch_to_device(it, self.device)):
                epoch_loss += self.train_step(state, batch, generator)

                if (i + 1) % eval_now == 0:
                    psnr = self.validate(state, val_batches())
                    if psnr > best_psnr:
                        best_psnr, best_epoch, best_iter = psnr, epoch, i
                        self._save("model_best", epoch, state,
                                   async_save=True)
                    self.log(
                        "[Ep %d it %d\t PSNR %s: %.4f\t] ----  "
                        "[best_Ep %d best_it %d Best_PSNR %.4f] " % (
                            epoch, i, opt.dataset, psnr, best_epoch,
                            best_iter, best_psnr))

            # reference logs get_lr() AFTER scheduler.step(), i.e. the LR
            # the next epoch will run at (train_denoise.py:218-221)
            lr = float(self.sched(state.step))
            if self.mesh is not None:
                # each rank summed its rows' mean losses: their mean is the
                # global batch's
                dist.all_reduce(epoch_loss, group=self.mesh.group)
                epoch_loss /= self.mesh.size
            self.log("Epoch: {}\tTime: {:.4f}\tLoss: {:.4f}\t"
                     "LearningRate {:.6f}".format(
                         epoch, time.time() - t0, float(epoch_loss), lr))
            self._save("model_latest", epoch, state, async_save=True)
            if epoch % opt.checkpoint == 0:
                self._save(f"model_epoch_{epoch}", epoch, state)
        wait_for_saves()
        if self.mesh is not None:
            crc = verify_replicated(self.model, self.mesh)
            self.log(f"weights crc32 {crc:08x}, equal on {self.mesh.size} "
                     f"ranks")
            dist.barrier(group=self.mesh.group)
        self.log("Now time is : " + datetime.datetime.now().isoformat())
        return state, best_psnr

    def _save(self, name: str, epoch: int, state: TrainState,
              async_save: bool = False):
        """best and latest are written on a thread (the step loop goes on
        once the weights are on the host); epoch-N in line. Rank 0 alone
        writes (every rank holds the same weights)."""
        if not self.is_main:
            return
        save_checkpoint(self.model_dir, name, epoch, self.model.state_dict(),
                        state.optimizer.state_dict(), step=state.step,
                        async_save=async_save)
