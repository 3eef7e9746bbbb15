from .features import extract_tower_features, make_vit_extractor
from .a_score_run import compute_a_scores
from .c_score_run import run_c_score
