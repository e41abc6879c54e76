"""Host I/O: threaded video capture and JPEG codecs (native fast path)."""

from fav_tpu_torch.io.video import VideoSource  # noqa: F401
from fav_tpu_torch.io.jpeg import frame_to_base64_jpeg  # noqa: F401
