from .sw import sw_scores, sw_score_ref
