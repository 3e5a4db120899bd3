"""refine_roofline_pct.single: the least time of one launch of the RANSAC
refine kernel (csrc/kabsch.cu, refine_kernel, launched as
ransac_refine_f32) over its mean device time in the traced segment
(lib/roofline.refine_bound_s at the segment's inlier counts)."""
from lib.trace import kernel_mean_s


def read(rec):
    if rec.profile is None or "refine_bound_s" not in rec.values:
        return None
    t = kernel_mean_s(rec.profile, "refine_kernel")
    return 100.0 * rec.values["refine_bound_s"] / t if t else None
