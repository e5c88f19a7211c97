"""Parameter validation (reference: QUILT/R/validators.R:1-115 plus the
STITCH validators it imports)."""
from __future__ import annotations

from typing import Optional

from ..config import ImputeConfig
from ..panel.prepare import PreparedReference


class QuiltValidationError(ValueError):
    pass


def validate_impute_config(cfg: ImputeConfig) -> None:
    if cfg.regionStart is not None or cfg.regionEnd is not None:
        if cfg.regionStart is None or cfg.regionEnd is None:
            raise QuiltValidationError(
                "regionStart and regionEnd must be given together"
            )
        if cfg.regionStart >= cfg.regionEnd:
            raise QuiltValidationError(
                f"regionStart ({cfg.regionStart}) must be < regionEnd "
                f"({cfg.regionEnd})"
            )
        if cfg.buffer < 0:
            raise QuiltValidationError("buffer must be >= 0")
    if cfg.nGibbsSamples < 1:
        raise QuiltValidationError("nGibbsSamples must be >= 1")
    if cfg.n_seek_its < 1:
        raise QuiltValidationError("n_seek_its must be >= 1")
    # seek-iteration constraints (validators.R:105-115)
    n_burn = cfg.resolved_n_burn_in_seek_its()
    if n_burn >= cfg.n_seek_its:
        raise QuiltValidationError(
            f"n_burn_in_seek_its ({n_burn}) must be < n_seek_its "
            f"({cfg.n_seek_its})"
        )
    # gibbs-iteration constraints (validators.R:83-102); block iterations
    # beyond the sweep count are simply skipped by the engine
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if bit < 1:
            raise QuiltValidationError(
                f"block gibbs iterations must be >= 1 (got {bit})"
            )
    if cfg.Knew > cfg.Ksubset:
        raise QuiltValidationError(
            f"Knew ({cfg.Knew}) must be <= Ksubset ({cfg.Ksubset})"
        )
    if cfg.method not in ("diploid", "nipt"):
        raise QuiltValidationError(f"unknown method {cfg.method!r}")
    if cfg.maxDifferenceBetweenReads < 1:
        raise QuiltValidationError("maxDifferenceBetweenReads must be >= 1")
    if cfg.heuristic_approach not in ("A", "B"):
        raise QuiltValidationError(
            f"heuristic_approach must be 'A' or 'B' "
            f"(got {cfg.heuristic_approach!r})"
        )
    if cfg.estimate_bq_using_truth_read_labels:
        # developer-only feature of the reference (functions.R usage of
        # truth read labels to re-estimate base qualities); intentionally
        # not implemented here — hard error instead of silently ignoring
        raise QuiltValidationError(
            "estimate_bq_using_truth_read_labels is not supported by "
            "quilt_tpu"
        )
    if not cfg.use_sample_is_diploid and cfg.method == "diploid":
        # the diploid Gibbs kernel is inherently specialized for the
        # two-haplotype case (reference toggles this at functions.R:2539);
        # the flag cannot disable that specialization
        from ..utils import print_message
        print_message(
            "Note: use_sample_is_diploid=FALSE has no effect; the "
            "diploid kernel always uses the specialized diploid path "
            "(documented deviation, see PARITY.md)"
        )


def validate_region_consistency(
    prep: PreparedReference, cfg: ImputeConfig
) -> None:
    """Prepare/impute region agreement (validators.R:56-80), plus
    prepare-time feature requirements of the requested impute mode."""
    if cfg.use_mspbwt and getattr(prep, "ms_indices", None) is None:
        raise QuiltValidationError(
            "use_mspbwt=True (the impute2 default) but the prepared "
            "reference has no mspbwt indices; re-run preparation with "
            "prepare2 (or prepare --use_mspbwt), or impute with "
            "--use_mspbwt=False"
        )
    if cfg.regionStart is None:
        return
    if prep.regionStart is None:
        raise QuiltValidationError(
            "prepared reference was built without a region but impute "
            "specifies one; re-run prepare with regionStart/regionEnd"
        )
    if (
        prep.regionStart != cfg.regionStart
        or prep.regionEnd != cfg.regionEnd
        or prep.buffer != cfg.buffer
    ):
        raise QuiltValidationError(
            f"region mismatch between prepare "
            f"({prep.regionStart}-{prep.regionEnd} buffer {prep.buffer}) and "
            f"impute ({cfg.regionStart}-{cfg.regionEnd} buffer {cfg.buffer})"
        )
