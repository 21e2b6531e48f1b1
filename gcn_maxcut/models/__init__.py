from gcn_maxcut.models.gcn import (
    GCNParams,
    GCNSoftmaxParams,
    gcn_conv_init,
    gcn_conv_apply,
    gcn_softmax_init,
    gcn_softmax_apply,
    gcn_dev_init,
    gcn_dev_apply,
    embedding_init,
    count_params,
)

__all__ = [
    "GCNParams",
    "GCNSoftmaxParams",
    "gcn_conv_init",
    "gcn_conv_apply",
    "gcn_softmax_init",
    "gcn_softmax_apply",
    "gcn_dev_init",
    "gcn_dev_apply",
    "embedding_init",
    "count_params",
]
