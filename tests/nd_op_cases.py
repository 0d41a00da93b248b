"""The op cases of the registry's parity tests: for each registered
op (less those with a test of their own, :data:`OWN_TESTS`), numpy
inputs drawn from a seed of the op's name, its parameters, which
inputs take a gradient and whether results must agree exactly.
Imports numpy alone, so the CPU tests (``test_torch_nd_ops.py``, which
hold the port against the JAX package) and ``chip_smoke.py`` (which
holds the card against the CPU) share one table."""
import zlib

import numpy as np

def rs_for(name):
    return np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))


def U(rs, shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def I(vals):
    return np.asarray(vals, np.float32)


def spd(rs, n=3):
    a = rs.uniform(-1, 1, (n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


# name -> (inputs(rs), params, grad argument indices or None, exact)
def _specs():
    s = {}

    def add(names, inputs, params=None, grad="all", exact=False):
        for n in names.split():
            s[n] = (inputs, params or {}, grad, exact)

    def u(shape, lo=-1.0, hi=1.0):
        return lambda rs: [U(rs, shape, lo, hi)]

    add("abs exp sin cos arcsin arccos arctan sinh cosh tanh arcsinh "
        "arctanh sigmoid softsign relu erf erfinv degrees radians identity "
        "copy _copy make_loss negative square tan log_sigmoid mish softplus "
        "hard_sigmoid expm1 MakeLoss", u((3, 4), -0.9, 0.9))
    add("log log2 log10 log1p sqrt rsqrt cbrt rcbrt reciprocal gamma "
        "gammaln digamma", u((3, 4), 0.5, 2.5))
    add("arccosh", u((3, 4), 1.2, 3.0))
    add("round rint fix floor ceil trunc sign", u((3, 4), -3, 3),
        grad=None, exact=True)
    add("logical_not", lambda rs: [I(rs.randint(0, 2, (3, 4)))], grad=None,
        exact=True)
    add("isnan isinf isfinite",
        lambda rs: [I([[1.0, np.nan, -np.inf], [np.inf, 0.5, -2.0]])],
        grad=None, exact=True)
    add("BlockGrad stop_gradient", u((3, 4)), grad=None)
    add("clip", u((3, 4)), {"a_min": -0.5, "a_max": 0.5})
    add("Cast cast amp_cast", u((3, 4)), {"dtype": "float64"}, grad=None)
    add("_constant", lambda rs: [], {"value": [[1.0, 2.0], [3.0, 4.0]]},
        grad=None)
    add("amp_multicast", lambda rs: [U(rs, (2, 3)),
                                     U(rs, (2, 3)).astype(np.float16)],
        {"num_outputs": 2}, grad=None)
    add("broadcast_add broadcast_sub broadcast_mul broadcast_div "
        "broadcast_maximum broadcast_minimum broadcast_hypot arctan2",
        lambda rs: [U(rs, (2, 3)), U(rs, (1, 3), 0.3, 1.0)])
    add("broadcast_mod broadcast_power",
        lambda rs: [U(rs, (2, 3), 0.5, 2.0), U(rs, (1, 3), 0.6, 1.5)])
    add("elemwise_add _plus _add elemwise_sub _minus _sub elemwise_mul _mul "
        "elemwise_div _div maximum minimum",
        lambda rs: [U(rs, (2, 3)), U(rs, (2, 3), 0.3, 1.0)])
    add("_power _mod",
        lambda rs: [U(rs, (2, 3), 0.5, 2.0), U(rs, (2, 3), 0.6, 1.5)])
    add("broadcast_equal broadcast_not_equal broadcast_greater "
        "broadcast_greater_equal broadcast_lesser broadcast_lesser_equal "
        "broadcast_logical_and broadcast_logical_or broadcast_logical_xor",
        lambda rs: [I(rs.randint(0, 3, (2, 3))), I(rs.randint(0, 3, (1, 3)))],
        grad=None, exact=True)
    add("broadcast_add_scalar _plus_scalar broadcast_sub_scalar "
        "_minus_scalar broadcast_mul_scalar _mul_scalar broadcast_div_scalar "
        "_div_scalar broadcast_maximum_scalar _maximum_scalar "
        "broadcast_minimum_scalar _minimum_scalar _rminus_scalar "
        "_rdiv_scalar", u((2, 3), 0.2, 2.0), {"scalar": 0.7})
    add("broadcast_mod_scalar _mod_scalar broadcast_power_scalar "
        "_power_scalar _rpower_scalar _rmod_scalar", u((2, 3), 0.5, 2.0),
        {"scalar": 1.3})
    add("broadcast_equal_scalar broadcast_not_equal_scalar "
        "broadcast_greater_scalar broadcast_greater_equal_scalar "
        "broadcast_lesser_scalar broadcast_lesser_equal_scalar",
        lambda rs: [I(rs.randint(0, 3, (2, 3)))], {"scalar": 1.0},
        grad=None, exact=True)
    add("add_n ElementWiseSum _sum",
        lambda rs: [U(rs, (2, 3)), U(rs, (2, 3)), U(rs, (2, 3))])
    add("where", lambda rs: [I(rs.randint(0, 2, (2, 3))), U(rs, (2, 3)),
                             U(rs, (2, 3))], grad=(1, 2))
    add("sum sum_axis nansum mean prod nanprod max max_axis min min_axis",
        u((2, 3, 4), 0.5, 1.5), {"axis": 1})
    add("norm", u((2, 3)), {"axis": 1})
    add("L2Normalization", u((2, 3, 4)))
    add("argmax argmin", u((3, 5)), {"axis": 1}, grad=None, exact=True)
    add("argmax_channel", u((3, 5)), grad=None, exact=True)
    add("reshape Reshape", u((2, 3, 4)), {"shape": (0, -4, 3, 1, -1)})
    add("reshape_like", lambda rs: [U(rs, (2, 6)), U(rs, (3, 4))], grad=(0,))
    add("shape_array size_array", u((2, 3, 4)), grad=None, exact=True)
    add("transpose", u((2, 3, 4)), {"axes": (1, 0, 2)})
    add("swapaxes SwapAxis", u((2, 3, 4)), {"dim1": 0, "dim2": 2})
    add("Flatten flatten", u((2, 3, 4)))
    add("expand_dims", u((2, 3)), {"axis": 1})
    add("squeeze", u((2, 1, 3)), {"axis": 1})
    add("broadcast_to", u((1, 3)), {"shape": (2, 0)})
    add("broadcast_like", lambda rs: [U(rs, (1, 3)), U(rs, (2, 3))],
        grad=(0,))
    add("broadcast_axis broadcast_axes", u((2, 1, 3)),
        {"axis": 1, "size": 4})
    add("tile", u((2, 3)), {"reps": (2, 1)})
    add("repeat", u((2, 3)), {"repeats": 2, "axis": 1})
    add("flip reverse", u((2, 3)), {"axis": 1})
    add("pad Pad", u((1, 1, 3, 3)),
        {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2),
         "constant_value": 0.5})
    add("depth_to_space", u((1, 4, 2, 3)), {"block_size": 2})
    add("space_to_depth", u((1, 1, 4, 6)), {"block_size": 2})
    add("_slice_get", u((3, 4)), {"key": (slice(0, 2), slice(None, None, 2))})
    add("slice crop", u((3, 4)), {"begin": (0, 1), "end": (2, 4)})
    add("slice_axis", u((3, 4)), {"axis": 1, "begin": 1, "end": 3})
    add("slice_like", lambda rs: [U(rs, (3, 4)), U(rs, (2, 3))], grad=(0,))
    add("take", lambda rs: [U(rs, (4, 3)), I([[0, 2], [3, 5]])], grad=(0,))
    add("batch_take", lambda rs: [U(rs, (3, 4)), I([0, 3, 1])], grad=(0,))
    add("pick", lambda rs: [U(rs, (3, 4)), I([0, 3, 1])], {"axis": 1},
        grad=(0,))
    add("gather_nd", lambda rs: [U(rs, (3, 4)), I([[0, 2], [1, 3]])],
        grad=(0,))
    add("scatter_nd", lambda rs: [U(rs, (2,)), I([[0, 2], [1, 3]])],
        {"shape": (3, 4)}, grad=(0,))
    add("one_hot", lambda rs: [I([0, 2, 1, 5])], {"depth": 4}, grad=None,
        exact=True)
    seq = {"use_sequence_length": True}
    add("SequenceMask SequenceLast SequenceReverse",
        lambda rs: [U(rs, (4, 2, 3)), I([2, 3])], seq, grad=(0,))
    add("concat Concat", lambda rs: [U(rs, (2, 3)), U(rs, (2, 2))],
        {"dim": 1})
    add("stack", lambda rs: [U(rs, (2, 3)), U(rs, (2, 3))], {"axis": 1})
    add("split SliceChannel", u((2, 6)), {"num_outputs": 3, "axis": 1},
        grad=None)
    add("split_v2", u((2, 6)), {"indices_or_sections": (2, 5), "axis": 1},
        grad=None)
    add("dot", lambda rs: [U(rs, (2, 3)), U(rs, (3, 4))])
    add("batch_dot", lambda rs: [U(rs, (2, 2, 3)), U(rs, (2, 3, 4))])
    add("matmul linalg_gemm2_nn", lambda rs: [U(rs, (2, 3)), U(rs, (3, 4))])
    add("khatri_rao", lambda rs: [U(rs, (2, 3)), U(rs, (4, 3))])
    add("sort", u((3, 5)), {"axis": -1, "is_ascend": False})
    add("argsort", u((3, 5)), grad=None, exact=True)
    add("topk", u((3, 5)), {"k": 2, "ret_typ": "both"}, grad=None)
    add("zeros_like ones_like", u((2, 3)), grad=None)
    add("_full_like", u((2, 3)), {"value": 2.5}, grad=None)
    add("_arange_like arange_like", u((2, 3)),
        {"start": 1.0, "step": 0.5, "axis": 1}, grad=None)
    add("linalg_gemm", lambda rs: [U(rs, (2, 3)), U(rs, (4, 3)),
                                   U(rs, (2, 4))],
        {"transpose_b": True, "alpha": 0.5, "beta": 2.0})
    add("linalg_gemm2", lambda rs: [U(rs, (3, 2)), U(rs, (3, 4))],
        {"transpose_a": True, "alpha": 1.5})
    add("linalg_potrf", lambda rs: [spd(rs)])
    chol = lambda rs: np.linalg.cholesky(spd(rs)).astype(np.float32)  # noqa
    add("linalg_trsm", lambda rs: [chol(rs), U(rs, (3, 2))])
    add("linalg_sumlogdiag linalg_potri", lambda rs: [chol(rs)])
    add("linalg_extractdiag", u((3, 3)), {"offset": 1})
    add("linalg_syrk", u((2, 3)), {"alpha": 0.5})
    add("linalg_trmm", lambda rs: [U(rs, (3, 3)), U(rs, (3, 2))])
    add("linalg_makediag", u((2, 3)), {"offset": 1})
    add("linalg_maketrian", u((2, 6)))
    add("linalg_extracttrian", u((2, 3, 3)))
    add("im2col", u((1, 2, 5, 5)),
        {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 1)})
    add("col2im", u((1, 18, 25)),
        {"output_size": (5, 5), "kernel": (3, 3), "pad": (1, 1)})
    add("diag", u((3, 4)), {"k": 1})
    add("smooth_l1", u((3, 4), -2, 2), {"scalar": 1.5})
    add("cumsum", u((3, 4)), {"axis": 1})
    add("unravel_index _unravel_index", lambda rs: [I([5, 7, 11])],
        {"shape": (3, 4)}, grad=None, exact=True)
    add("ravel_multi_index _ravel_multi_index",
        lambda rs: [I([[1, 2, 0], [0, 3, 2]])], {"shape": (3, 4)},
        grad=None, exact=True)
    # op_impl_nn
    add("Activation", u((3, 4)), {"act_type": "softrelu"})
    add("LeakyReLU", u((3, 4)), {"act_type": "elu", "slope": 0.3})
    add("gelu", u((3, 4)), {"approximate": True})
    add("swish", u((3, 4)), {"beta": 1.5})
    add("softmax log_softmax softmin", u((3, 4)), {"axis": -1})
    add("SoftmaxActivation", u((2, 3, 4)))
    lab = lambda rs: [U(rs, (3, 4)), I([0, 2, 1])]  # noqa: E731
    add("SoftmaxOutput Softmax", lab, {"grad_scale": 0.5}, grad=(0,))
    add("softmax_cross_entropy", lambda rs: [U(rs, (4, 5)), I([0, 4, 2, 1])],
        grad=(0,))
    add("batch_dot_attention_scores batch_dot_attention_apply",
        lambda rs: [U(rs, (2, 2, 3, 4)), U(rs, (2, 2, 4, 4))])
    add("attention_length_mask attention_zero_empty_rows",
        lambda rs: [U(rs, (2, 1, 3, 4)), I([3, 0])], grad=(0,))
    add("attention_segment_mask attention_zero_pad_rows",
        lambda rs: [U(rs, (2, 1, 4, 4)), I([[1, 1, 2, 0], [1, 2, 2, 2]])],
        grad=(0,))
    add("segment_valid_len", lambda rs: [I([[1, 1, 2, 0], [1, 0, 0, 0]])],
        grad=None, exact=True)
    add("causal_mask_scores", u((2, 1, 3, 4)))
    add("flash_attention",
        lambda rs: [U(rs, (2, 2, 5, 8)), U(rs, (2, 2, 5, 8)),
                    U(rs, (2, 2, 5, 8)), I([5, 3])], grad=(0, 1, 2))
    add("LayerNorm", lambda rs: [U(rs, (3, 8)), U(rs, (8,), 0.5, 1.5),
                                 U(rs, (8,))], {"eps": 1e-5})
    add("InstanceNorm", lambda rs: [U(rs, (2, 3, 4)), U(rs, (3,), 0.5, 1.5),
                                    U(rs, (3,))])
    add("GroupNorm", lambda rs: [U(rs, (2, 4, 3)), U(rs, (4,), 0.5, 1.5),
                                 U(rs, (4,))], {"num_groups": 2})
    add("BatchNormTrain", lambda rs: [U(rs, (2, 3, 4)), U(rs, (3,), 0.5, 1.5),
                                      U(rs, (3,))], grad=None)
    add("Embedding", lambda rs: [I([[0, 3, 9], [2, 2, 5]]), U(rs, (10, 4))],
        {"input_dim": 10, "output_dim": 4}, grad=(1,))
    add("FullyConnected",
        lambda rs: [U(rs, (2, 3, 4)), U(rs, (5, 12)), U(rs, (5,))],
        {"num_hidden": 5})
    add("Convolution",
        lambda rs: [U(rs, (1, 2, 5, 5)), U(rs, (3, 2, 3, 3)), U(rs, (3,))],
        {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)})
    add("Pooling", u((1, 2, 4, 4)),
        {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"})
    add("LinearRegressionOutput MAERegressionOutput "
        "LogisticRegressionOutput",
        lambda rs: [U(rs, (3, 2)), U(rs, (3, 2))], {"grad_scale": 2.0},
        grad=(0,))
    return s


SPECS = _specs()
# covered by their own tests below (eager wrappers, state, randomness)
OWN_TESTS = {"BatchNorm", "Dropout", "RNN", "sgd_update", "sgd_mom_update",
             "adam_update", "adagrad_update", "adamw_update",
             "multi_sgd_update", "multi_sgd_mom_update", "nag_mom_update",
             "mp_sgd_update", "mp_sgd_mom_update", "rmsprop_update",
             "rmspropalex_update", "ftrl_update", "signsgd_update",
             "signum_update", "adadelta_update", "lamb_update_phase1",
             "lamb_update_phase2", "multi_mp_sgd_update",
             "multi_mp_sgd_mom_update", "Custom", "ctc_loss", "CTCLoss",
             "_contrib_ctc_loss", "random_uniform",
             "_random_uniform",
             "uniform", "random_normal", "_random_normal", "normal",
             "random_gamma", "_random_gamma", "random_exponential",
             "_random_exponential", "exponential", "random_poisson",
             "_random_poisson", "poisson", "random_negative_binomial",
             "_random_negative_binomial", "random_randint",
             "_random_randint", "randint", "sample_uniform", "sample_normal",
             "sample_gamma", "sample_multinomial", "_sample_multinomial",
             "multinomial", "shuffle", "_shuffle", "bernoulli",
             "_sample_bernoulli"}
