"""Video segmentation serving for the port."""
from tpuseg_torch.video.pipeline import SyntheticFrames, VideoSegmenter  # noqa: F401
