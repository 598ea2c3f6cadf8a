"""The benchmark's arithmetic: operations and bytes of the model and of
the search kernels at a configuration's shapes, and the card's peaks.  Each
function takes a configuration file's ``model`` tree, so a new
configuration needs no code here."""

import json
from pathlib import Path


def peaks() -> dict:
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)
