__version__ = "0.1.0"

# Index log schema version written into every log entry
# (ref: HS/index/LogEntry.scala:23-30 — versioned log-entry base).
INDEX_LOG_VERSION = "0.1"
