"""``PipelineParallel`` (counterpart of paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py:1-115).

The reference's single-controller semantics: ``train_batch`` splits the
batch into ``accumulate_steps`` micro-batches along dim 0, runs each
micro-batch's forward and backward with its loss scaled by
``1 / accumulate_steps`` (so the gradients are those of the mean of the
micro-losses), then steps the optimizer once. No p2p and no collective:
every stage is in this process, as on the reference's global view. The
stacked SPMD pipeline with ``ppermute`` between stages is the trainer's
(``parallel/pipeline.py``).
"""
from __future__ import annotations

import torch

from .meta_parallel_base import MetaParallelBase

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave"]


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        pconf = strategy.pipeline_configs if strategy is not None else {}
        self.micro_batch_size = pconf.get("micro_batch_size", 1)
        self.accumulate_steps = pconf.get("accumulate_steps", 1)
        self.total_loss = None

    @property
    def _layers(self):
        return self._layers_holder

    def _split_micro(self, data):
        xs = data if isinstance(data, (tuple, list)) else (data,)
        n = self.accumulate_steps
        micros = []
        for i in range(n):
            parts = []
            for x in xs:
                if isinstance(x, torch.Tensor):
                    mb = x.shape[0] // n
                    parts.append(x[i * mb:(i + 1) * mb])
                else:
                    parts.append(x)
            micros.append(tuple(parts))
        return micros

    def forward_backward_pipeline(self, data, scaler=None):
        """Each micro-batch's forward and backward, the loss scaled by
        ``1 / accumulate_steps`` (and by ``scaler``); returns the mean
        micro-loss in float32, accumulated on the device (no host sync
        between micro-batches)."""
        micros = self._split_micro(data)
        total = None
        for inputs in micros:
            x, label = inputs if len(inputs) == 2 else (inputs[0], None)
            out = self._layers.forward(x)
            loss = self._layers.loss(out, label) if label is not None \
                else out
            scaled = loss * (1.0 / self.accumulate_steps)
            if scaler is not None:
                scaled = scaler.scale(scaled)
            scaled.backward()
            ldata = loss.detach().float()
            total = ldata if total is None else total + ldata
        self.total_loss = total / len(micros)
        return self.total_loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is None:
            optimizer.step()
        else:
            scaler.step(optimizer)
            scaler.update()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        self._layers.eval()
        total = None
        for inputs in self._split_micro(data):
            x, label = inputs if len(inputs) == 2 else (inputs[0], None)
            out = self._layers.forward(x)
            loss = self._layers.loss(out, label) if compute_loss else out
            ldata = loss.detach().float()
            total = ldata if total is None else total + ldata
        return total / self.accumulate_steps

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class PipelineParallelWithInterleave(PipelineParallel):
    """Virtual-stage interleave: the single-controller schedule is the
    same micro-batch accumulation (the interleaved ring is the
    trainer's, ``LlamaSpmdTrainer(n_virtual=...)``)."""
