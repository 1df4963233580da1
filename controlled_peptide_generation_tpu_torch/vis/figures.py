"""The diagnostics' figures: drawn with matplotlib where it is installed.

matplotlib is an optional plotting dependency, imported only here and only
when a diagnostic draws. Without it the figures are named in one log line
and skipped; every number is computed all the same and written to the
diagnostic's JSON or text file.
"""

import logging

LOG = logging.getLogger("GenerationAPI")


def pyplot(names):
    """matplotlib.pyplot on the agg backend, or None where matplotlib is
    not installed; then logs once the figures ``names`` (paths) that the
    caller will not draw."""
    try:
        import matplotlib
    except ImportError:
        LOG.info("matplotlib is not installed; figures not drawn: %s",
                 ", ".join(names))
        return None
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    return plt
