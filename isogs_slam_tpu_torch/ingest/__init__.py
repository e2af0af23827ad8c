from .sources import (DirectorySource, FrameSource,  # noqa: F401
                      make_source, write_capture_frame)
