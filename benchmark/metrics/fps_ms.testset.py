"""fps_ms.testset (registration program, ms a pair): the mean span of the
stage ``fps`` (the detector threshold and FPS keypoints), from the
program's timing events at the stage's bounds, recorded inside its
captured graphs on the chain's stream, over the pairs of the untraced
window's calls. With U chains side by side the span also holds the time
the card spent on the other chains' work."""

from benchmark.harness import records


def read(run):
    return records.stage_ms(run, "fps")
