"""Ops and arguments of the port's ``ops/`` that no op spec of
``tests/op`` reaches (modes, negative axes and strides, ``keepdim``,
tuple axes, int and bool inputs, numpy's indexing rules, the in-place
methods), each against the JAX package on the same inputs; and the
reference behaviours the port changes there (ROADMAP Queue C)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.framework import device as tdevice
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    before = tdevice._CURRENT_DEVICE
    tpaddle.set_device("cpu")
    yield
    tdevice._CURRENT_DEVICE = before


_R = np.random.RandomState(20)
_X = _R.randn(3, 4).astype(np.float32)
_Y = _R.randn(4, 3).astype(np.float32)
_X3 = _R.randn(2, 3, 4).astype(np.float32)
_X4 = _R.randn(1, 2, 4, 5).astype(np.float32)
_SQ = (_R.randn(4, 4) + 4 * np.eye(4)).astype(np.float32)
_SPD = (_SQ @ _SQ.T).astype(np.float32)
_V = _R.randn(5).astype(np.float32)
_I = np.array([[2, 0, 2, 1], [1, 1, 0, 3], [3, 3, 3, 0]], np.int32)
_M = _X > 0
_TIES = np.array([[1.0, 3.0, 3.0, 2.0], [0.0, 0.0, -1.0, 5.0]], np.float32)
_NAN = np.where(_X > 1.0, np.nan, _X).astype(np.float32)

# name: fn(paddle, t) with t = paddle.to_tensor
EXTRA_OPS = {
    "unique_all": lambda p, t: p.unique(
        t(_I), return_index=True, return_inverse=True, return_counts=True),
    "unique_consecutive_all": lambda p, t: p.unique_consecutive(
        t(np.array([1, 1, 2, 2, 3, 1], np.int32)), return_inverse=True,
        return_counts=True),
    "put_along_axis_add": lambda p, t: p.put_along_axis(
        t(_X), t(_I[:, :2] % 4), t(_X[:, :2]), 1, "add"),
    "put_along_axis_mul": lambda p, t: p.put_along_axis(
        t(_X), t(_I[:, :2] % 4), 2.0, 1, "mul"),
    "pad_reflect_all_dims": lambda p, t: p.pad(t(_X), [1, 1, 2, 0],
                                               mode="reflect"),
    "pad_replicate_nchw": lambda p, t: p.pad(t(_X4), [1, 2, 0, 1],
                                             mode="replicate"),
    "pad_circular_nhwc": lambda p, t: p.pad(
        t(_X4), [1, 0, 2, 1], mode="circular", data_format="NHWC"),
    "pad_constant_value": lambda p, t: p.pad(t(_X4), [1, 2], value=0.5),
    "strided_slice_negative": lambda p, t: p.strided_slice(
        t(_X), [0, 1], [2, 3], [-4, 0], [-1, -2]),
    "gather_0d_index": lambda p, t: p.gather(t(_X), t(np.array(2)), axis=1),
    "scatter_accumulate": lambda p, t: p.scatter(
        t(_X), t(np.array([2, 0, 2])), t(_X[::-1] * 2), overwrite=False),
    "index_put_accumulate": lambda p, t: p.index_put(
        t(_X), (t(np.array([0, 2, 0])),), t(_X[:3]), accumulate=True),
    "take_wrap": lambda p, t: p.take(t(_X), t(np.array([-1, 13, 5])),
                                     mode="wrap"),
    "take_clip": lambda p, t: p.take(t(_X), t(np.array([-1, 13, 5])),
                                     mode="clip"),
    "cummax_ties": lambda p, t: p.cummax(t(_TIES), axis=1),
    "cummin_flat": lambda p, t: p.cummin(t(_TIES)),
    "median_axes": lambda p, t: p.median(t(_X3), axis=[0, 2]),
    "median_keepdim_all": lambda p, t: p.median(t(_X), keepdim=True),
    "quantile_list_keepdim": lambda p, t: p.quantile(
        t(_X), [0.25, 0.75], axis=1, keepdim=True),
    "nanquantile": lambda p, t: p.nanquantile(t(_NAN), 0.5, axis=0),
    "frexp": lambda p, t: p.frexp(t(_X * 10)),
    "lstsq_all": lambda p, t: p.linalg.lstsq(t(_Y), t(_Y[:, :2] + 1)),
    "histogramdd": lambda p, t: p.histogramdd(t(_X[:, :2]), bins=3)[0],
    "cov_weights": lambda p, t: p.linalg.cov(
        t(_X), fweights=t(np.array([1, 2, 1, 3], np.int32)),
        aweights=t(np.abs(_V[:4]))),
    "corrcoef_cols": lambda p, t: p.linalg.corrcoef(t(_Y), rowvar=False),
    "kthvalue_keepdim": lambda p, t: p.kthvalue(t(_X), 2, axis=0,
                                                keepdim=True),
    "topk_smallest": lambda p, t: p.topk(t(_X), 2, axis=0, largest=False),
    "argmax_flat_keepdim": lambda p, t: p.argmax(t(_X), keepdim=True),
    "argsort_descending": lambda p, t: p.argsort(t(_X), axis=0,
                                                 descending=True),
    "squeeze_all": lambda p, t: p.squeeze(t(_X4[:, :1])),
    "unsqueeze_negative": lambda p, t: p.unsqueeze(t(_X), [-1, 0]),
    "split_minus_one": lambda p, t: p.split(t(_X), [1, -1], axis=1),
    "expand_keep": lambda p, t: p.expand(t(_X[:1]), [2, 3, -1]),
    "reshape_zero": lambda p, t: p.reshape(t(_X3), [0, -1]),
    "roll_flat": lambda p, t: p.roll(t(_X), 3),
    "repeat_interleave_tensor": lambda p, t: p.repeat_interleave(
        t(_X), t(np.array([1, 2, 0], np.int32)), axis=0),
    "nonzero_tuple": lambda p, t: p.nonzero(t(_M), as_tuple=True),
    "where_condition_only": lambda p, t: p.where(t(_M)),
    "masked_select_broadcast": lambda p, t: p.masked_select(t(_X),
                                                            t(_M[:1])),
    "diagonal_offset": lambda p, t: p.diagonal(t(_X3), 1, 1, 2),
    "fill_diagonal_": lambda p, t: t(_SQ).fill_diagonal_(2.0, offset=1),
    "unfold_asymmetric_pad": lambda p, t: p.unfold(
        t(_X4), [2, 2], strides=2, paddings=[1, 0, 0, 1]),
    "crop_minus_one": lambda p, t: p.crop(t(_X), [-1, 2], [1, 1]),
    "slice_negative": lambda p, t: p.slice(t(_X), [1], [-3], [-1]),
    "tensordot_lists": lambda p, t: p.tensordot(t(_X), t(_Y),
                                                axes=[[1], [0]]),
    "std_biased_keepdim": lambda p, t: p.std(t(_X), axis=1, unbiased=False,
                                             keepdim=True),
    "prod_axes_keepdim": lambda p, t: p.prod(t(_X3), axis=[0, 2],
                                             keepdim=True),
    "sum_int_dtype": lambda p, t: p.sum(t(_I), dtype="float32"),
    "sum_bool": lambda p, t: p.sum(t(_M), axis=0),
    "mean_int": lambda p, t: p.mean(t(_I)),
    "cumsum_flat": lambda p, t: p.cumsum(t(_X)),
    "cumprod_flat": lambda p, t: p.cumprod(t(_X)),
    "logcumsumexp_flat": lambda p, t: p.logcumsumexp(t(_X)),
    "count_nonzero_keepdim": lambda p, t: p.count_nonzero(t(_I),
                                                          keepdim=True),
    "clip_tensor_bounds": lambda p, t: p.clip(
        t(_X), t(np.float32(-0.5)), t(np.float32(0.5))),
    "lerp_tensor_weight": lambda p, t: p.lerp(t(_X), t(_X * 2),
                                              t(np.abs(_X))),
    "addmm": lambda p, t: p.addmm(t(_X), t(_X), t(_SQ), 0.5, 2.0),
    "dot_rows": lambda p, t: p.dot(t(_X), t(_X + 1)),
    "cross_axis": lambda p, t: p.cross(t(_X[:, :3]), t(_Y[:3]), axis=1),
    "diff_prepend_append": lambda p, t: p.diff(
        t(_X), prepend=t(_X[:, :1]), append=t(_X[:, :2])),
    "trapezoid_dx": lambda p, t: p.trapezoid(t(_X), dx=0.5),
    "cumulative_trapezoid_x": lambda p, t: p.cumulative_trapezoid(
        t(_X), t(np.cumsum(np.abs(_X), axis=1))),
    "rot90_k2": lambda p, t: p.rot90(t(_X3), 2, [1, 2]),
    "vander_increasing": lambda p, t: p.vander(t(_V), 3, increasing=True),
    "scale_bias_first": lambda p, t: p.scale(t(_X), 2.0, 1.0,
                                             bias_after_scale=False),
    "nan_to_num_bounds": lambda p, t: p.nan_to_num(
        t(np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)), 1.0,
        9.0, -9.0),
    "stanh": lambda p, t: p.stanh(t(_X)),
    "i1": lambda p, t: p.i1(t(_X)),
    "i1e": lambda p, t: p.i1e(t(_X)),
    "bitwise_and_bool": lambda p, t: p.bitwise_and(t(_M), t(~_M[::-1])),
    "isclose_nan": lambda p, t: p.isclose(t(_NAN), t(_NAN), equal_nan=True),
    "equal_all_shapes": lambda p, t: p.equal_all(t(_X), t(_X[:2])),
    "all_axes_keepdim": lambda p, t: p.all(t(_M), axis=[0, 1],
                                           keepdim=True),
    "any_flat": lambda p, t: p.any(t(_M)),
    "isposinf": lambda p, t: p.isposinf(t(np.array([np.inf, -np.inf, 1.0],
                                                   np.float32))),
    "searchsorted_rows_right": lambda p, t: p.searchsorted(
        t(np.sort(_X, axis=1)), t(_X[:, :2]), right=True),
    "bucketize_int32": lambda p, t: p.bucketize(t(_V), t(np.sort(_X[0])),
                                                out_int32=True),
    "norm_p1_axis": lambda p, t: p.norm(t(_X), p=1, axis=1, keepdim=True),
    "norm_inf_axis": lambda p, t: p.norm(t(_X), p=float("inf"), axis=0),
    "norm_nuc": lambda p, t: p.norm(t(_X), p="nuc", axis=[0, 1]),
    "norm_p0": lambda p, t: p.norm(t(_X), p=0),
    "dist_inf": lambda p, t: p.dist(t(_X), t(_X * 0.5), p=float("inf")),
    "matrix_power_negative": lambda p, t: p.linalg.matrix_power(t(_SQ), -2),
    "pinv_hermitian": lambda p, t: p.linalg.pinv(t(_SPD), hermitian=True),
    "triangular_solve_transposed": lambda p, t: p.linalg.triangular_solve(
        t(np.triu(_SQ)), t(_Y), upper=True, transpose=True),
    "triangular_solve_unit": lambda p, t: p.linalg.triangular_solve(
        t(np.tril(_SQ)), t(_Y), upper=False, unitriangular=True),
    "cholesky_upper": lambda p, t: p.linalg.cholesky(t(_SPD), upper=True),
    "lu_infos": lambda p, t: p.linalg.lu(t(_SQ), get_infos=True),
    "histogram_data_range": lambda p, t: p.histogram(t(_X), bins=4),
    "bincount_weights": lambda p, t: p.bincount(
        t(np.array([0, 3, 3, 1], np.int32)), weights=t(_V[:4]),
        minlength=6),
    "cdist_p1": lambda p, t: p.cdist(t(_X), t(_X[:2] + 1), p=1.0),
    "trace_offset": lambda p, t: p.trace(t(_X), offset=1),
    "full_int": lambda p, t: p.full([2, 3], 7),
    "full_like_dtype": lambda p, t: p.full_like(t(_X), 2, dtype="int32"),
    "arange_float_step": lambda p, t: p.arange(0.5, 3.0, 0.5),
    "eye_rectangular": lambda p, t: p.eye(2, 4, dtype="int32"),
    "diag_padding": lambda p, t: p.diag(t(_V[:3]), padding_value=9.0),
    "diag_embed_offset": lambda p, t: p.diag_embed(t(_X[:, :2]), offset=1),
    "meshgrid_three": lambda p, t: p.meshgrid(t(_V[:2]), t(_V[:3]),
                                              t(_V[:4])),
    "tril_indices_offset": lambda p, t: p.tril_indices(4, 3, -1),
    "triu_indices_offset": lambda p, t: p.triu_indices(3, 5, 1),
    "one_hot": lambda p, t: p.one_hot(t(_I), 4),
    "polar": lambda p, t: p.polar(t(np.abs(_X)), t(_X)),
    "assign_into": lambda p, t: p.assign(t(_X * 3), t(_X)),
    "zeros_like_dtype": lambda p, t: p.zeros_like(t(_X), dtype="bool"),
    "rank_shape": lambda p, t: (p.rank(t(_X3)), p.shape(t(_X3))),
    "getitem_int_slice_array": lambda p, t: t(_X3)[1, ::2, [0, 3]],
    "getitem_int_array_adjacent": lambda p, t: t(_X3)[:, 1, [0, 3]],
    "getitem_bool_mask": lambda p, t: t(_X)[t(_M)],
    "getitem_ellipsis_none": lambda p, t: t(_X3)[..., None, 1],
    "reshape_method_inplace": lambda p, t: t(_X).reshape_([4, 3]),
    "squeeze_method_inplace": lambda p, t: t(_X4[:, :1]).squeeze_(1),
    "scatter_method_inplace": lambda p, t: t(_X).scatter_(
        t(np.array([1])), t(_X[:1] * 2)),
    "index_add_method_inplace": lambda p, t: t(_X).index_add_(
        t(np.array([0, 0])), 0, t(_X[:2])),
}


@pytest.mark.parametrize("name", sorted(EXTRA_OPS))
def test_op_beyond_the_specs_matches_jax(name):
    """An op or an argument no op spec reaches (modes, negative axes and
    strides, keepdim, tuple axes, int and bool inputs, in-place methods)
    on the port against the JAX package: the same dtype names, values
    within 1e-5 (float32: summation order only)."""
    outs = []
    for pkg in (jpaddle, tpaddle):
        out = EXTRA_OPS[name](pkg, pkg.to_tensor)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        outs.append(out)
    assert len(outs[0]) == len(outs[1])
    for j, t in zip(*outs):
        assert tpaddle.framework.dtype.dtype_name(t.dtype) == \
            np.dtype(j.dtype).name, name
        a = np.asarray(j.numpy())
        b = t.numpy()
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                   equal_nan=True, err_msg=name)


def test_diagonals_off_the_main_one_differ_from_the_reference():
    """Queue C item 21: the reference's ``diag(x, offset, padding_value)``
    rolls an identity mask, which wraps around into the far corner, and
    its ``fill_diagonal_(value, offset)`` fills min(rows, cols) - |offset|
    entries of a non-square matrix; the port fills every off-diagonal
    entry with the padding and the whole offset diagonal, as Paddle
    does."""
    v = np.array([1.0, 2.0, 3.0], np.float32)
    want = np.full((4, 4), 9.0, np.float32)
    want[[1, 2, 3], [0, 1, 2]] = v
    np.testing.assert_array_equal(
        tpaddle.diag(tpaddle.to_tensor(v), offset=-1,
                     padding_value=9.0).numpy(), want)
    ref = jpaddle.diag(jpaddle.to_tensor(v), offset=-1,
                       padding_value=9.0).numpy()
    assert ref[0, 3] == 0.0     # the wrapped mask entry
    x = np.zeros((3, 4), np.float32)
    got = tpaddle.to_tensor(x).fill_diagonal_(2.0, offset=1).numpy()
    assert got[[0, 1, 2], [1, 2, 3]].tolist() == [2.0, 2.0, 2.0]
    ref = jpaddle.to_tensor(x).fill_diagonal_(2.0, offset=1).numpy()
    assert ref[2, 3] == 0.0
