"""What a solve costs outside its chunks: its wall time minus the sum of its
``chunk_seconds`` (the program's own span of each chunk, ended by the
chunk's host read), averaged over the window's solves. It holds the drawing
of canvases and weights, the data's copy to the device and the results'
copies back (the canvas, the best output, the parameters)."""
UNIT = "ms"


def read(rec):
    if not rec.solves:
        return None
    return 1e3 * sum(s["wall"] - sum(s["chunk_s"]) for s in rec.solves) / len(rec.solves)
