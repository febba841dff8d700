"""Device milliseconds per image of detection and descriptors: saliency,
NMS, selection, refinement, bilinear samples, PCA and quantisation
(``ops/scoring.py``, ``ops/detect.py``, ``ops/interpolate.py``,
``ViTExtractor._detect``): the work launched inside the ``bench.detect``
span, which the traced run wraps around the extractor's ``_detect``."""


def read(ctx):
    images = ctx.counters.get("images", 0)
    device_s = ctx.trace.device_s_under("bench.detect")
    if not images or not device_s:
        return None
    return 1e3 * device_s / images
