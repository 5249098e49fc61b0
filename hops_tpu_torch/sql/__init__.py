"""Analytic SQL gateway (the reference's Hive surface, re-based on sqlite) (counterpart of
``hops_tpu/sql/__init__.py``, copied with the port's imports).

Reference: ``hops.hive.setup_hive_connection()`` + PyHive
(notebooks/hive/PyHive.ipynb:46) and the two-way-TLS Hive JDBC client
(hive/src/.../HiveJDBCClient.java — SURVEY.md §2.8). The port has
no Hive; SQL over feature-store tables runs in-process on sqlite3
(stdlib), with a DB-API-shaped connection for PyHive-style callers.
"""

from hops_tpu_torch.sql.gateway import connection, execute  # noqa: F401

__all__ = ["connection", "execute"]
