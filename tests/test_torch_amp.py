"""The port's AMP (paddle_tpu_torch.amp, the op-boundary hook in
framework/op.py) held against the JAX package on the CPU.

- The cast policy: for every op name of both lists, plus
  ``elementwise_add``, ``layer_norm``, ``embedding``, ``dropout``,
  ``cast`` and an unknown name, the dtypes ``maybe_cast_inputs`` gives
  float32, bfloat16, float16 and int inputs equal the JAX package's, at
  O0/O1/O2/OD, bf16 and fp16, with and without custom lists. Exact: a
  cast policy is control plane.
- ``decorate`` keeps every Parameter object (the optimizer's list and
  BERT's tied decoder see the bf16 weights).
- ``GradScaler``: over a scripted run of finite, inf and NaN gradients
  the scale, the skipped steps and ``state_dict`` after every step equal
  the JAX package's, through ``minimize`` and through ``step`` +
  ``update``.
- ``check_numerics``, the tensor checker (the hook's nan/inf scan) and
  operator stats (the hook's call counts, equal to the JAX package's
  for the same small model).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.framework import op
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

jax_cast = importlib.import_module("paddle_tpu.amp.auto_cast")
port_cast = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

NAMES = sorted(port_cast.WHITE_LIST | port_cast.BLACK_LIST | {
    "elementwise_add", "layer_norm", "embedding", "dropout", "cast",
    "an_unknown_op"})
KINDS = ("float32", "bfloat16", "float16", "int32")
CUSTOM = {"none": (None, None),
          "custom": ({"layer_norm", "softmax"}, {"linear", "dropout"})}


def _jax_inputs():
    base = paddle.to_tensor(np.ones(2, np.float32))
    return [base.astype(k) if k != "float32" else base for k in KINDS]


def _port_inputs():
    return [torch.ones(2, dtype=getattr(torch, k)) for k in KINDS]


def _kind(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("custom", sorted(CUSTOM))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "OD"])
def test_cast_policy_matches_jax(level, dtype, custom):
    white, black = CUSTOM[custom]
    kw = dict(custom_white_list=white, custom_black_list=black, level=level,
              dtype=dtype)
    ji, pi = _jax_inputs(), _port_inputs()
    for name in NAMES:
        with paddle.amp.auto_cast(**kw):
            want = [_kind(t) for t in jax_cast.maybe_cast_inputs(name, ji)]
        with amp.auto_cast(**kw):
            got = [_kind(t) for t in port_cast.maybe_cast_inputs(name, pi)]
            hooked = [_kind(t) for t in op.op_inputs(name, *pi)]
        assert got == want == hooked, (name, got, want)
    # the state is the thread's and is restored on exit
    assert not amp.amp_state().enabled


def test_auto_cast_nests_and_restores():
    with amp.auto_cast(level="O2"):
        with amp.auto_cast(enable=False):
            assert not amp.amp_state().enabled
        assert amp.amp_state().level == "O2"
    assert not amp.amp_state().enabled
    with pytest.raises(ValueError):
        amp.auto_cast(level="O3")


def test_decorate_keeps_parameters_and_the_tie():
    cfg = BertConfig.tiny(vocab=100, hidden=32, layers=1, heads=2, inter=64)
    m = BertForPretraining(cfg, device="cpu")
    before = {n: p for n, p in m.named_parameters()}
    opt = AdamW(1e-3, parameters=m.parameters(), multi_precision=True)
    out = amp.decorate(m, level="O2", dtype="bfloat16")
    assert out is m
    after = dict(m.named_parameters())
    assert all(after[n] is p for n, p in before.items())
    assert all(p.dtype == torch.bfloat16 for p in after.values())
    assert all(a is b for a, b in zip(opt._parameter_list,
                                      before.values()))
    assert m.cls._tied[0] is m.bert.embeddings.word_embeddings.weight
    # O1 leaves the weights alone; (model, optimizer) come back together
    m1 = BertForPretraining(cfg, device="cpu")
    got = amp.decorate([m1], [opt], level="O1")
    assert got[0] == [m1] and got[1] == [opt]
    assert all(p.dtype == torch.float32 for p in m1.parameters())


# a scripted run: each step's gradient factor (inf and NaN steps skip)
SCRIPT = [1.0, 2.0, np.inf, 1.0, np.nan, np.inf, 1.0, 1.0, 1.0, -np.inf,
          0.5, 1.0]


def _run_jax(use_minimize):
    paddle.seed(0)
    w = paddle.create_parameter([3], "float32")
    opt = paddle.optimizer.AdamW(0.1, parameters=[w])
    sc = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=2,
                               decr_every_n_nan_or_inf=2)
    out = []
    for f in SCRIPT:
        c = paddle.to_tensor(np.array([1.0, f, 2.0], np.float32))
        before = np.array(w.numpy())
        scaled = sc.scale((w * c).sum())
        scaled.backward()
        if use_minimize:
            sc.minimize(opt, scaled)
        else:
            sc.step(opt)
            sc.update()
            opt.clear_grad()
        out.append((float(sc.get_loss_scaling().numpy()),
                    not np.array_equal(before, np.array(w.numpy())),
                    sc.state_dict()))
    return out


def _run_port(use_minimize):
    w = torch.nn.Parameter(torch.tensor([0.5, -0.25, 1.0]))
    opt = AdamW(0.1, parameters=[w])
    sc = amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                        decr_every_n_nan_or_inf=2)
    out = []
    for f in SCRIPT:
        c = torch.tensor([1.0, f, 2.0])
        before = w.detach().clone()
        scaled = sc.scale((w * c).sum())
        scaled.backward()
        if use_minimize:
            sc.minimize(opt, scaled)
        else:
            sc.step(opt)
            sc.update()
            opt.clear_grad()
        out.append((float(sc.get_loss_scaling()),
                    not torch.equal(before, w.detach()), sc.state_dict()))
    return out


@pytest.mark.parametrize("use_minimize", [True, False])
def test_grad_scaler_sequence_matches_jax(use_minimize):
    want, got = _run_jax(use_minimize), _run_port(use_minimize)
    assert got == want
    assert [s for _, s, _ in got].count(False) == 4   # inf/NaN skipped


def test_grad_scaler_load_and_disabled():
    sc = amp.GradScaler(init_loss_scaling=8.0)
    sc.load_state_dict({"scale": 4.0, "incr_count": 3, "decr_count": 1})
    assert sc.state_dict()["scale"] == 4.0
    assert sc.state_dict()["incr_count"] == 3
    off = amp.GradScaler(enable=False)
    w = torch.nn.Parameter(torch.ones(2))
    loss = (w * 3).sum()
    assert off.scale(loss) is loss
    off.minimize(AdamW(0.1, parameters=[w]), loss)
    assert not torch.equal(w.detach(), torch.ones(2))


def test_check_numerics():
    from paddle_tpu_torch.amp import debugging as dbg
    assert dbg.check_numerics(torch.ones(3)) == (0, 0)
    assert dbg.check_numerics(torch.arange(3)) == (0, 0)
    with pytest.raises(RuntimeError, match="nan=1 inf=2"):
        dbg.check_numerics(torch.tensor([np.nan, np.inf, -np.inf, 1.0]),
                           "matmul", "x")
    jdbg = paddle.amp.debugging
    with pytest.raises(RuntimeError, match="nan=1 inf=2"):
        jdbg.check_numerics(paddle.to_tensor(
            np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)))


def test_tensor_checker_scans_hooked_ops():
    from paddle_tpu_torch.amp import debugging as dbg
    lin = nn.Linear(4, 4, device="cpu")
    bad = torch.tensor([[1.0, np.nan, 0.0, 0.0]])
    lin(bad)                                    # off: no scan
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(True))
    try:
        assert paddle_tpu_torch.get_flag("FLAGS_check_nan_inf")
        with pytest.raises(RuntimeError, match="linear.*NaN/Inf"):
            lin(bad)
        lin(torch.ones(1, 4))
    finally:
        dbg.disable_tensor_checker()
    lin(bad)
    assert not op._Watch.on


def _jax_mlp_stats():
    jdbg = paddle.amp.debugging
    paddle.seed(0)
    l1, l2 = paddle.nn.Linear(4, 8), paddle.nn.Linear(8, 4)
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    jdbg.enable_operator_stats_collection()
    y = paddle.nn.functional.softmax(
        l2(paddle.nn.functional.gelu(l1(x))) + x)
    paddle.nn.functional.tanh(y)
    return jdbg.disable_operator_stats_collection()


def test_operator_stats_match_jax(capsys):
    from paddle_tpu_torch.amp import debugging as dbg
    l1 = nn.Linear(4, 8, device="cpu")
    l2 = nn.Linear(8, 4, device="cpu")
    x = torch.ones(2, 4)
    with dbg.collect_operator_stats():
        y = F.softmax(op.add(l2(F.gelu(l1(x))), x))
        F.tanh(y)
    got = dbg.disable_operator_stats_collection()     # already stopped
    assert got == {}
    dbg.enable_operator_stats_collection()
    F.softmax(op.add(l2(F.gelu(l1(x))), x))
    F.tanh(torch.ones(1))
    got = dbg.disable_operator_stats_collection()
    assert "linear" in capsys.readouterr().out
    want = _jax_mlp_stats()
    assert got == {k: want[k] for k in got}
    assert got == {"linear": 2, "gelu": 1, "elementwise_add": 1,
                   "softmax": 1, "tanh": 1}
    assert not op._Watch.on


def test_compare_accuracy(tmp_path):
    from paddle_tpu_torch.amp import debugging as dbg
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    np.save(a / "x.npy", np.ones(3, np.float32))
    np.save(b / "x.npy", np.array([1.0, 1.5, 1.0], np.float32))
    np.save(a / "y.npy", np.ones(2))
    np.save(b / "y.npy", np.ones(3))
    rows = dbg.compare_accuracy(str(a), str(b), str(tmp_path / "o.csv"))
    assert rows[0] == ("x.npy", 0.5, pytest.approx(1 / 6), False)
    assert rows[1][1].startswith("shape-mismatch")
    assert (tmp_path / "o.csv").read_text().startswith("tensor,max_diff")
