"""Entry ``features``: whole slides as host-resident (N, D) f32 patch
features, each handed to ``SlidePredictor.predict_features`` by one client
in a closed loop (k-means, the five folds, the upload and the readback);
a slide's time runs from hand-in to its genes on the host."""

from benchmark import serving


def run(ctx: dict) -> dict:
    return serving.run(ctx, from_patches=False)
