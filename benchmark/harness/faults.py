"""Faults planted in the program under test, each of which a run has to
come out not correct with (``tests/test_bench_faults.py`` on the CPU,
``calibrate.py --fault`` on the card)."""


def half_batch(loss):
    """``loss`` (the program's ``render_loss``) taken over the top half of
    the image alone, the mean over that half: half of the batch left out."""

    def half(rgb, target, lambda_dssim=0.2):
        h = rgb.shape[0] // 2
        return loss(rgb[:h], target[:h], lambda_dssim)

    return half
