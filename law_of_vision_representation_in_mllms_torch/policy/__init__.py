from .fit import poly_features, fit_policy, PolicyFit
from .data import ACTable, load_ac_csv, BENCHMARKS, ALL_MODELS, OPTIMAL
from .predict import subset_search, prediction_accuracy
from .validate import validate_run
