"""Audio-reactivity metrics: the correlation zoo, rhythmic and chromatic
reactivity, the per-file evaluation, the comparison harness, the AV feature
study, the preliminary study and the image-quality metrics.  The context FID's
names, which ``ssar_tpu/metrics/__init__.py`` exports (``CausalCNNEncoder``,
``context_fid``, ``train_encoder``), are imported from their module
(``metrics.context_fid``): it builds on ``models``, which import this
package through the patch system."""
from .analysis import COVARIANCE_DISTANCES, knn_kl_divergence, mutual_information, pca
from .chroma import chromatic_reactivity
from .comparison import (
    LucidSonicBaseline,
    RandomGenerator,
    SelfSupervisedOptimization,
    SupervisedSequenceModel,
    compare_models,
    evaluate_trained_checkpoint_dirs,
    from_video_dir,
    supplementary_material,
)
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
from .ood import compute as compute_ood
from .ood import frechet_distance, kernel_distance, prdc
from .preliminary import (
    compare_av_feats,
    gramian_angular_field,
    joint_recurrence_plot,
    minirocket_fit,
    minirocket_transform,
    preliminary_study,
)
from .rhythmic import dtw_distance, metric_sensitivity_study, percentile_clip, rhythmic_reactivity
from .sectional import evaluate_file, evaluate_reactivity
from .study import av_feature_study
