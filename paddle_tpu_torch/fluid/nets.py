"""``fluid.nets``: the composed networks of ``paddle_tpu/fluid/nets.py``
over the port's layers: ``simple_img_conv_pool`` (:8) and
``img_conv_group`` (:25)."""
from ..layers import batch_norm, conv2d, dropout, pool2d
from ._not_ported import not_ported


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """conv2d (+ bias, act) then pool2d."""
    conv_out = conv2d(input, num_filters, filter_size, stride=conv_stride,
                      padding=conv_padding, dilation=conv_dilation,
                      groups=conv_groups, param_attr=param_attr,
                      bias_attr=bias_attr, act=act)
    return pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                  pool_stride=pool_stride, pool_padding=pool_padding,
                  global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A conv2d (batch_norm, dropout) for each of ``conv_num_filter``, then
    pool2d."""
    tmp = input
    for nf in conv_num_filter:
        tmp = conv2d(tmp, nf, conv_filter_size, padding=conv_padding,
                     param_attr=param_attr,
                     act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = batch_norm(tmp, act=conv_act)
            if abs(conv_batchnorm_drop_rate) > 1e-5:
                tmp = dropout(tmp, dropout_prob=conv_batchnorm_drop_rate)
    return pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                  pool_stride=pool_stride)


_QUEUE_OF = {"sequence_conv_pool": "A8", "glu": "A8",
             "scaled_dot_product_attention": "A8"}


def __getattr__(name):
    if name in _QUEUE_OF:
        raise not_ported(__name__, name, _QUEUE_OF[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
