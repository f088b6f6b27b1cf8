"""Layer builders generated from the op registry.

Counterpart of ``paddle_tpu/layers/auto.py`` (the reference's
``layer_function_generator``): ``generate_layer_fn(op_type)`` builds a
Fluid-style builder from an op's registered slots, and each name of
``_OP_BACKED`` (the JAX file's table, :64-201) whose op the port
registers (:203-213, ``installed()``) resolves to one, built on its first
use. The port's ``layers`` are static
only, so the builders are too: each appends its op to the current block.
The JAX file's re-exports of its dual-mode ``tensor`` functions (:215-228)
wait for the port's ``tensor`` namespace (``ROADMAP.md`` A8); ``split``,
``slice``, ``stack`` and ``unstack`` are static builders of ``nn.py``.
"""
from __future__ import annotations

from typing import Optional

from ..core.registry import REGISTRY
from .helper import append_with_new_outputs

__all__ = ["generate_layer_fn"]


def generate_layer_fn(op_type: str, out_slots=None):
    """Positional args map onto the op's input slots in declared order
    (a list for a duplicable slot), keyword args named as a slot feed
    it, and every other keyword is an attr. Returns one var, or a tuple
    in declared output order when the op has several outputs."""
    opdef = REGISTRY.get(op_type)
    in_slots = list(opdef.input_slots)
    all_out = list(out_slots or opdef.output_slots)

    def fn(*args, name: Optional[str] = None, **kwargs):
        if len(args) > len(in_slots):
            raise TypeError("%s takes at most %d tensor args (%s)"
                            % (op_type, len(in_slots), in_slots))
        ins = {}
        for slot, arg in zip(in_slots, args):
            if arg is not None:
                ins[slot] = list(arg) if isinstance(arg, (list, tuple)) \
                    else [arg]
        attrs = {}
        for k, v in kwargs.items():
            if k in in_slots:
                if v is not None:
                    ins[k] = list(v) if isinstance(v, (list, tuple)) \
                        else [v]
            else:
                attrs[k] = v
        outs = append_with_new_outputs(op_type, ins, attrs,
                                       {s: 1 for s in all_out})
        outs = [outs[s][0] for s in all_out]
        return outs[0] if len(outs) == 1 else tuple(outs)

    fn.__name__ = op_type
    fn.__doc__ = ("Generated builder of op %r (inputs %s, outputs %s)."
                  % (op_type, in_slots, all_out))
    return fn


# the JAX file's names backed one to one by a registered op: name ->
# (op type, output slots or None)
_OP_BACKED = {
    "affine_channel": ("affine_channel", None),
    "affine_grid": ("affine_grid", None),
    "anchor_generator": ("anchor_generator", None),
    "add_position_encoding": ("add_position_encoding", None),
    "bilinear_tensor_product": ("bilinear_tensor_product", None),
    "bipartite_match": ("bipartite_match", None),
    "box_clip": ("box_clip", None),
    "box_coder": ("box_coder", None),
    "box_decoder_and_assign": ("box_decoder_and_assign", None),
    "bpr_loss": ("bpr_loss", None),
    "center_loss": ("center_loss", None),
    "chunk_eval": ("chunk_eval", None),
    "clip_by_norm": ("clip_by_norm", None),
    "collect_fpn_proposals": ("collect_fpn_proposals", None),
    "continuous_value_model": ("cvm", None),
    "cos_sim": ("cos_sim", None),
    "crop": ("crop", None),
    "crop_tensor": ("crop_tensor", None),
    "ctc_greedy_decoder": ("ctc_greedy_decoder", None),
    "data_norm": ("data_norm", None),
    "deformable_conv": ("deformable_conv", None),
    "density_prior_box": ("density_prior_box", None),
    "detection_output": ("detection_output", None),
    "ssd_loss": ("ssd_loss", None),
    "dice_loss": ("dice_loss", None),
    "distribute_fpn_proposals": ("distribute_fpn_proposals", None),
    "edit_distance": ("edit_distance", None),
    "elementwise_floordiv": ("elementwise_floordiv", None),
    "elementwise_mod": ("elementwise_mod", None),
    "elu": ("elu", None),
    "expand": ("expand", None),
    "expand_as": ("expand_as", None),
    "fill_constant_batch_size_like": ("fill_constant_batch_size_like",
                                      None),
    "filter_by_instag": ("filter_by_instag", None),
    "fsp_matrix": ("fsp", None),
    "gather_tree": ("gather_tree", None),
    "gaussian_random": ("gaussian_random", None),
    "generate_mask_labels": ("generate_mask_labels", None),
    "generate_proposal_labels": ("generate_proposal_labels", None),
    "generate_proposals": ("generate_proposals", None),
    "get_tensor_from_selected_rows": ("get_tensor_from_selected_rows",
                                      None),
    "grid_sampler": ("grid_sampler", None),
    "group_norm": ("group_norm", None),
    "hash": ("hash", None),
    "huber_loss": ("huber_loss", None),
    "im2sequence": ("im2sequence", None),
    "inplace_abn": ("inplace_abn", None),
    "instance_norm": ("instance_norm", None),
    "iou_similarity": ("iou_similarity", None),
    "isfinite": ("isfinite", None),
    "kldiv_loss": ("kldiv_loss", None),
    "l2_normalize": ("l2_normalize", None),
    "label_smooth": ("label_smooth", None),
    "locality_aware_nms": ("locality_aware_nms", None),
    "lod_reset": ("lod_reset", None),
    "log_loss": ("log_loss", None),
    "logical_not": ("logical_not", None),
    "lrn": ("lrn", None),
    "lstm_unit": ("lstm_unit", None),
    "margin_rank_loss": ("margin_rank_loss", None),
    "matrix_nms": ("matrix_nms", None),
    "maxout": ("maxout", None),
    "mean_iou": ("mean_iou", None),
    "merge_selected_rows": ("merge_selected_rows", None),
    "mish": ("mish", None),
    "mse_loss": ("square_error_cost", None),
    "multiclass_nms": ("multiclass_nms", None),
    "multiplex": ("multiplex", None),
    "nce": ("nce", None),
    "npair_loss": ("npair_loss", None),
    "soft_relu": ("soft_relu", None),
    "uniform_random_batch_size_like":
        ("uniform_random_batch_size_like", None),
    "gaussian_random_batch_size_like":
        ("gaussian_random_batch_size_like", None),
    "pad": ("pad", None),
    "pad2d": ("pad2d", None),
    "pad_constant_like": ("pad_constant_like", None),
    "pixel_shuffle": ("pixel_shuffle", None),
    "polygon_box_transform": ("polygon_box_transform", None),
    "prelu": ("prelu", None),
    "prior_box": ("prior_box", None),
    "prroi_pool": ("prroi_pool", None),
    "psroi_pool": ("psroi_pool", None),
    "random_crop": ("random_crop", None),
    "rank_loss": ("rank_loss", None),
    "retinanet_detection_output": ("retinanet_detection_output", None),
    "reverse": ("reverse", None),
    "roi_align": ("roi_align", None),
    "roi_perspective_transform": ("roi_perspective_transform", None),
    "roi_pool": ("roi_pool", None),
    "row_conv": ("row_conv", None),
    "retinanet_target_assign": ("retinanet_target_assign", None),
    "rpn_target_assign": ("rpn_target_assign", None),
    "deformable_roi_pooling": ("deformable_roi_pooling", None),
    "sampling_id": ("sampling_id", None),
    "scatter_nd": ("scatter_nd", None),
    "selu": ("selu", None),
    "sequence_concat": ("sequence_concat", None),
    "sequence_enumerate": ("sequence_enumerate", None),
    "sequence_expand": ("sequence_expand", None),
    "sequence_expand_as": ("sequence_expand_as", None),
    "sequence_mask": ("sequence_mask", None),
    "sequence_pad": ("sequence_pad", None),
    "sequence_reshape": ("sequence_reshape", None),
    "sequence_reverse": ("sequence_reverse", None),
    "sequence_scatter": ("sequence_scatter", None),
    "sequence_slice": ("sequence_slice", None),
    "sequence_softmax": ("sequence_softmax", None),
    "sequence_unpad": ("sequence_unpad", None),
    "shard_index": ("shard_index", None),
    "shuffle_channel": ("shuffle_channel", None),
    "sigmoid_cross_entropy_with_logits":
        ("sigmoid_cross_entropy_with_logits", None),
    "sigmoid_focal_loss": ("sigmoid_focal_loss", None),
    "similarity_focus": ("similarity_focus", None),
    "smooth_l1": ("smooth_l1_loss", None),
    "space_to_depth": ("space_to_depth", None),
    "spectral_norm": ("spectral_norm", None),
    "stanh": ("stanh", None),
    "target_assign": ("target_assign", None),
    "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss",
                                     None),
    "temporal_shift": ("temporal_shift", None),
    "unbind": ("unbind", None),
    "unfold": ("unfold", None),
    "uniform_random": ("uniform_random", None),
    "warpctc": ("warpctc", None),
    "yolo_box": ("yolo_box", None),
    "yolov3_loss": ("yolov3_loss", None),
}


def installed():
    """The names of ``_OP_BACKED`` whose op the port registers: those this
    module builds."""
    from .. import ops  # noqa: F401  (registers the lowerings)
    return sorted(n for n, (op, _) in _OP_BACKED.items()
                  if REGISTRY.has(op))


def __getattr__(name):
    # built on first use: the op modules import this package (through
    # layers.helper) before their registrations are all in
    entry = _OP_BACKED.get(name)
    if entry is not None and name in installed():
        fn = globals()[name] = generate_layer_fn(*entry)
        return fn
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def sum(x, name=None):  # noqa: A001
    """fluid.layers.sum: the elementwise sum of a list of vars (the
    ``sum`` op), not a reduction."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    return append_with_new_outputs("sum", {"X": xs}, {}, {"Out": 1})["Out"][0]


__all__.append("sum")
