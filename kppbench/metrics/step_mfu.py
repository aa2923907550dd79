"""step_mfu: the operations of the model's steps over the window (the
reference's passes per column-step on its sampled ocean columns, each
counted by ``yardstick.pass_ops``, scaled to the ocean columns and to the
window's N steps) over the traced window's seconds times the card's
float32 peak (67 TFLOP/s, H100 SXM, outside the tensor cores), in
percent.  The same work whatever computes it, so folding glue into a
kernel moves it too."""


def read(run):
    if not run.stats or not run.stats.get("device_events"):
        return None
    seconds = run.stats["window_ms"] / 1e3
    return 100.0 * run.ops_per_step * run.steps / (seconds * run.peaks[0])
