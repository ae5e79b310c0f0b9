"""The share of the nnets' frames that were padding: one less the frames
they needed (the valid frames, once through the encoder and once a sample
through the decoder) over the frames the program counted them run over
(``NNET_FRAMES``, summed by the task over the traced steps); None where
the program keeps no such count."""


def read(trace):
    frames = trace.totals.get("nnet_frames")
    if trace.task != "svae_train" or not frames:
        return None
    return 100.0 * (1.0 - trace.work["nnet_valid_frames"] * trace.calls / frames)
