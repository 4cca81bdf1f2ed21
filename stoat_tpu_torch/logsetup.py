"""TRACE log level (the reference's 5th verbosity tier, log.hpp:17-23).

Registered at import so library callers get ``logger.trace`` without
going through the CLI.  -V 0..4 maps Error, Warning, Info, Debug, Trace.
"""

import logging

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def _trace(self, message, *args, **kwargs):
    if self.isEnabledFor(TRACE):
        self._log(TRACE, message, args, **kwargs)


if not hasattr(logging.Logger, "trace"):
    logging.Logger.trace = _trace
