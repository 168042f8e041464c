"""bourbonlint for the port — static invariant checks over ``repro_torch``.

``python port/scripts/lint.py`` runs the four rules over
``port/repro_torch``; see README.md in this package for the rule table,
the suppression/baseline workflow and why the reference's JITDISC rule
has no counterpart here.  Pure Python over ``ast``: importing it loads
neither ``torch`` nor the JAX package.
"""

from .core import (Finding, Rule, SourceFile, apply_baseline, load_baseline,
                   make_baseline, run_lint, save_baseline, SUPPRESS)
from .deadmod import DEAD_MODULE_ALLOWLIST, dead_module_report
from .durorder import DurabilityOrderRule
from .hotsync import HotSyncRule
from .obsdrift import ObsDriftRule
from .pairing import PairingRule

ALL_RULES = ("HOTSYNC", "DURORDER", "PAIRING", "OBSDRIFT")

__all__ = ["Finding", "Rule", "SourceFile", "run_lint", "default_rules",
           "ALL_RULES", "load_baseline", "save_baseline", "make_baseline",
           "apply_baseline", "dead_module_report", "DEAD_MODULE_ALLOWLIST",
           "HotSyncRule", "DurabilityOrderRule", "PairingRule",
           "ObsDriftRule", "SUPPRESS"]


def default_rules(root: str, only=None):
    """The production rule set for the repository root ``root`` (OBSDRIFT
    reads the port's live declarations under it).  ``only`` filters by
    rule id."""
    rules = [
        HotSyncRule(),
        DurabilityOrderRule(),
        PairingRule(),
        ObsDriftRule.from_root(root),
    ]
    if only:
        wanted = {r.upper() for r in only}
        rules = [r for r in rules if r.id in wanted]
    return rules
