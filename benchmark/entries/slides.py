"""Entry ``slides``: whole slides as host-resident uint8 patches, each
handed to ``SlidePredictor.predict_patches`` by one client in a closed
loop; a slide's time runs from hand-in to its genes on the host."""

from benchmark import serving


def run(ctx: dict) -> dict:
    return serving.run(ctx, from_patches=True)
