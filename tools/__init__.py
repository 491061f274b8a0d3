"""Command-line tools of the repo; a package so that `tools.<name>` imports
from the repo root ahead of any other `tools`."""
