from .plots import (plot_law_scatter, plot_policy_bar, plot_radar,
                    plot_sampling_curve, write_ac_score_csv)
