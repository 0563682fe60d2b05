"""Evaluation: TS2Vec C-FID on the card, the metrics, feature measures and
FID on the host, DTW on the native kernel or the card (counterpart of
t2ms_tpu/evaluate; ``dtw_wavefront*`` stand where JAX has ``dtw_jax*``)."""

from t2ms_tpu_torch.evaluate.dtw import (calculate_dtw, dtw_native,
                                         dtw_numpy, dtw_wavefront,
                                         dtw_wavefront_batch)
from t2ms_tpu_torch.evaluate.feature_measures import (calculate_acd,
                                                      calculate_kd,
                                                      calculate_mdd,
                                                      calculate_sd)
from t2ms_tpu_torch.evaluate.fid import calculate_fid
from t2ms_tpu_torch.evaluate.metrics import (MinMaxScaler,
                                             calculate_correlational_score,
                                             calculate_crps, calculate_ed,
                                             calculate_mrr, calculate_mse,
                                             calculate_sequence_correlation,
                                             calculate_wape,
                                             min_max_normalize_columns,
                                             mrr_at_10, normalize_per_row,
                                             sequence_correlation, wape,
                                             zscore_normalize_columns)
from t2ms_tpu_torch.evaluate.ts2vec import TS2Vec, initialize_ts2vec

__all__ = [
    "TS2Vec", "calculate_acd", "calculate_correlational_score",
    "calculate_crps", "calculate_dtw", "calculate_ed", "calculate_fid",
    "calculate_kd", "calculate_mdd", "calculate_mrr", "calculate_mse",
    "calculate_sd", "calculate_sequence_correlation", "calculate_wape",
    "dtw_native", "dtw_numpy", "dtw_wavefront", "dtw_wavefront_batch",
    "initialize_ts2vec", "min_max_normalize_columns", "mrr_at_10",
    "MinMaxScaler", "normalize_per_row", "sequence_correlation", "wape",
    "zscore_normalize_columns",
]
