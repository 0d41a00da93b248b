"""AMP op lists (MXNet's ``contrib/amp/lists/symbol.py``): which ops
run in the half type and which in float32, by op name. A copy of
``mxnet_tpu/contrib/amp/lists.py``: the products (fully connected,
convolution, RNN, embedding, dots) run in the half type; reductions,
normalizations and softmaxes in float32."""

# run in the target half type (the products)
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "matmul", "RNN", "Embedding", "linalg_gemm", "linalg_gemm2",
]

# always fp32 (numerics-sensitive)
FP32_OPS = [
    "softmax", "log_softmax", "SoftmaxOutput", "softmax_cross_entropy",
    "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm", "L2Normalization",
    "mean", "sum", "norm", "exp", "log",
]

# fp32 unless inputs already half (conditional)
CONDITIONAL_FP32_OPS = []

# run in wider of input dtypes
WIDEST_TYPE_CASTS = ["broadcast_add", "broadcast_sub", "broadcast_mul",
                     "broadcast_div", "add_n", "concat", "where"]
