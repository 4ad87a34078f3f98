"""Video features, optical flow and visual beats."""
from .features import (
    VIDEO_FEATURES,
    absdiff,
    adaptive_freq_rms,
    directogram,
    high_freq_rms,
    hsv_hist,
    low_freq_rms,
    mid_freq_rms,
    optical_flow,
    rgb_hist,
    rgb_to_hsv,
    video_flow_onsets,
    video_spectral_onsets,
    video_spectrogram,
    visual_variance,
)
from .flow import (
    farneback_flow,
    farneback_parametrized,
    lucas_kanade_pyramid,
    poly_expansion_certainty,
)
