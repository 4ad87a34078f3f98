"""Audio-reactivity metrics: the correlation zoo, rhythmic and chromatic
reactivity, and the per-file evaluation."""
from .chroma import chromatic_reactivity
from .correlation import (
    CORRELATION_FNS,
    foci_codependence,
    linear_cka,
    pearson,
    procrustes,
    rv,
    rv2,
    sgw,
    smi,
    spearman,
    svcca,
    xi,
)
from .rhythmic import dtw_distance, metric_sensitivity_study, percentile_clip, rhythmic_reactivity
from .sectional import evaluate_file, evaluate_reactivity
