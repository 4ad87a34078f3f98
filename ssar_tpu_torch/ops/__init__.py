"""Tensor ops: the three hand-written CUDA kernels' wrappers and plain
versions, filters, quantiles, resampling, upfirdn.

Re-exports the counterpart of each name ``ssar_tpu/ops/__init__.py``
exports.  Where the JAX name is Pallas-specific, the port's own name stands
in its place:

- ``absdiff_pallas`` -> ``absdiff`` (B2 on a CUDA tensor); ``absdiff_ref``
  -> ``absdiff_plain``;
- ``sliding_median_lastaxis`` -> ``sliding_median_cuda`` (B1's CUDA route;
  ``median_filter`` launches it on a CUDA tensor) and ``median_filter_plain``;
- ``s4d_vandermonde_pallas`` -> ``s4d_vandermonde`` (B3 on a CUDA tensor);
  ``s4d_vandermonde_ref`` -> ``s4d_vandermonde_plain``.

Importing this package builds no kernel: ``_build.py`` builds each at its
first launch.
"""
from .absdiff import absdiff, absdiff_plain, video_absdiff
from .dct import dct
from .gaussian import gaussian_filter
from .iir import high_pass, highpass_biquad, low_pass, lowpass_biquad, mid_pass
from .median import median_filter, median_filter2d_freq, median_filter2d_time, median_filter_plain
from .median_cuda import sliding_median_cuda
from .quantile import (
    clamp_lower_percentile,
    clamp_peaks_percentile,
    clamp_upper_percentile,
    masked_quantile,
    quantile,
)
from .resample import resample
from .vandermonde import s4d_kernel_fused, s4d_vandermonde, s4d_vandermonde_plain
