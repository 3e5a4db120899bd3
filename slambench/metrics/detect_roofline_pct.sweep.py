"""detect_roofline_pct.sweep: the least time of one launch of the detect
kernel (csrc/detect_corners.cu, detect_pyramid_kernel: the four pyramid
levels of one frame) over its mean device time in the traced segment
(lib/roofline.detect_bound_s)."""
from lib.trace import kernel_mean_s


def read(rec):
    if rec.profile is None or "detect_bound_s" not in rec.values:
        return None
    t = kernel_mean_s(rec.profile, "detect_pyramid_kernel")
    return 100.0 * rec.values["detect_bound_s"] / t if t else None
