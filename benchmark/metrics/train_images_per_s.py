"""224^2 images trained in the window over its seconds; a cine volume of
T frames counts T images. The window ends in a synchronize."""


def read(run):
    if "images" not in run:
        return None
    return run["images"] / run["window_s"]
