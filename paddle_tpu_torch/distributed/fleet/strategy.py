"""DistributedStrategy (counterpart of paddle_tpu/distributed/fleet/
strategy.py:1-82): plain-python fields mirroring the messages of
Paddle's ``distributed_strategy.proto`` that fleet reads, above all
``hybrid_configs`` and ``tensor_parallel_configs``."""
from __future__ import annotations


class _Config(dict):
    """dict with attribute access, mirroring proto message fields."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # hybrid degrees (proto HybridConfig, distributed_strategy.proto:324)
        self.hybrid_configs = _Config(
            dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
            sep_degree=1,
            mp_configs=_Config(sync_param=False, sync_grad=False,
                               sync_moment=False),
            pp_configs=_Config(delay_scale_loss=False,
                               dp_comm_overlap=False,
                               enable_timer=False),
        )
        # AMPConfig (proto :26)
        self.amp = False
        self.amp_configs = _Config(
            init_loss_scaling=32768.0, incr_every_n_steps=1000,
            decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
            use_dynamic_loss_scaling=True, custom_white_list=[],
            custom_black_list=[], use_pure_fp16=False, use_fp16_guard=True,
            use_bf16=True)
        # RecomputeConfig
        self.recompute = False
        self.recompute_configs = _Config(checkpoints=[],
                                         enable_offload=False,
                                         checkpoint_shape=[])
        # ShardingConfig
        self.sharding = False
        self.sharding_configs = _Config(
            sharding_degree=8, stage=1, mp_degree=1, segment_broadcast_MB=32,
            accumulate_steps=1, offload=False)
        # PipelineConfig
        self.pipeline = False
        self.pipeline_configs = _Config(accumulate_steps=1,
                                        micro_batch_size=1,
                                        schedule_mode="1F1B")
        self.gradient_merge = False
        self.gradient_merge_configs = _Config(k_steps=1, avg=True)
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Config(tensor_parallel_degree=1,
                                               tensor_init_seed=-1)
        self.lamb = False
        self.lars = False
        self.lars_configs = _Config(lars_coeff=0.001,
                                    lars_weight_decay=0.0005,
                                    epsilon=1e-9,
                                    exclude_from_weight_decay=[])
        self.dgc = False
        self.dgc_configs = _Config(rampup_begin_step=0, rampup_step=1,
                                   sparsity=[0.999])
        self.localsgd = False
        self.localsgd_configs = _Config(k_steps=1, begin_step=1)
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = False
        self.gradient_scale_configs = _Config(scale_strategy="avg")

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()}
        return f"DistributedStrategy({fields})"
