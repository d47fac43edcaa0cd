"""Model FLOPs of the profiled rounds in % of the card's f32-accurate
peak: every live update's trained samples (``frozen/cost.py``: three
forwards a sample) and every round's test forwards, over the rounds'
wall time at split TF32's rate (494.7 / 3 TFLOP/s).  Pad rows and
recomputation are not model FLOPs."""

from flbench.frozen.cost import (SPLIT_TF32_FLOPS_PER_S, cnn_eval_flops,
                                 cnn_train_flops)


def read(trace):
    if trace.profiled_s <= 0 or not trace.profiled or not trace.ops:
        return None
    cfg, tr = trace.config, trace.traffic
    b = tr["batch_size"]
    per_update = max(tr["samples_per_client"] // b, 1) * b \
        * tr["local_epochs"]
    live = sum(c["live"] for i in trace.profiled
               for c in trace.rounds[i]["calls"])
    flops = (live * per_update * cnn_train_flops(cfg)
             + len(trace.profiled) * tr["test_samples"]
             * cnn_eval_flops(cfg))
    return 100.0 * flops / (trace.profiled_s * SPLIT_TF32_FLOPS_PER_S)
