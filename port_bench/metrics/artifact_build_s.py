"""artifact_build_s: the benchmark's host span around the decode
artifact's build (`DecoderArtifact(net, models)`) in set-up."""


def read(run):
    return run.spans.get("artifact_build_s")
