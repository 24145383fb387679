"""CRUD generator: reflect a dataclass entity into REST routes + SQL.

Parity with gofr `pkg/gofr/crud_handlers.go`: the first dataclass field is the
primary key (`crud_handlers.go:83`); POST/GET/GET-all/PUT/DELETE are registered
(`crud_handlers.go:115-148`) with default implementations built on the
dialect-aware query builder (`crud_handlers.go:150-289`); users override any
operation by defining ``create/get_all/get/update/delete`` methods on the
entity class, and ``__table_name__``/``__rest_path__`` override naming.

The port's own copy of gofr_tpu/crud.py.
"""

from __future__ import annotations

import dataclasses
import re

from gofr_tpu_torch.datasource import sql as sqlb
from gofr_tpu_torch.http.errors import EntityNotFound


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


_SQL_TYPES = {int: "INTEGER", float: "REAL", str: "TEXT", bytes: "BLOB", bool: "INTEGER"}


def register_crud_routes(app, entity: type, table: str | None = None, path: str | None = None) -> None:
    if not dataclasses.is_dataclass(entity):
        raise TypeError("add_rest_handlers requires a dataclass entity")
    fields = dataclasses.fields(entity)
    if not fields:
        raise TypeError("entity has no fields")
    pk = fields[0].name
    columns = [f.name for f in fields]
    table = table or getattr(entity, "__table_name__", None) or _snake(entity.__name__)
    path = path or getattr(entity, "__rest_path__", None) or _snake(entity.__name__)
    path = "/" + path.strip("/")

    ensured = set()  # DDL runs once per DB handle, not per request

    def _ensure_table(ctx) -> None:
        if id(ctx.sql) in ensured:
            return
        cols = ", ".join(
            f"{sqlb.quote_ident(f.name, ctx.sql.dialect)} {_SQL_TYPES.get(f.type if not isinstance(f.type, str) else str, 'TEXT')}"
            + (" PRIMARY KEY" if f.name == pk else "")
            for f in fields
        )
        ctx.sql.execute(f"CREATE TABLE IF NOT EXISTS {sqlb.quote_ident(table, ctx.sql.dialect)} ({cols})")
        ensured.add(id(ctx.sql))

    def create(ctx):
        if hasattr(entity, "create"):
            return entity.create(ctx)
        _ensure_table(ctx)
        obj = ctx.bind(entity)
        values = [getattr(obj, c) for c in columns]
        ctx.sql.execute(sqlb.insert_query(table, columns, ctx.sql.dialect), values)
        return f"{entity.__name__} successfully created with id: {getattr(obj, pk)}"

    def get_all(ctx):
        if hasattr(entity, "get_all"):
            return entity.get_all(ctx)
        _ensure_table(ctx)
        return ctx.sql.select_into(entity, sqlb.select_all_query(table, ctx.sql.dialect))

    def get_one(ctx):
        if hasattr(entity, "get"):
            return entity.get(ctx)
        _ensure_table(ctx)
        key = ctx.path_param(pk)
        rows = ctx.sql.select_into(entity, sqlb.select_by_query(table, pk, ctx.sql.dialect), [key])
        if not rows:
            raise EntityNotFound(pk, key)
        return rows[0]

    def update(ctx):
        if hasattr(entity, "update"):
            return entity.update(ctx)
        _ensure_table(ctx)
        key = ctx.path_param(pk)
        obj = ctx.bind(entity)
        non_pk = [c for c in columns if c != pk]
        values = [getattr(obj, c) for c in non_pk] + [key]
        affected = ctx.sql.execute(sqlb.update_query(table, non_pk, pk, ctx.sql.dialect), values)
        if affected == 0:
            raise EntityNotFound(pk, key)
        return f"{entity.__name__} successfully updated with id: {key}"

    def delete(ctx):
        if hasattr(entity, "delete"):
            return entity.delete(ctx)
        _ensure_table(ctx)
        key = ctx.path_param(pk)
        affected = ctx.sql.execute(sqlb.delete_query(table, pk, ctx.sql.dialect), [key])
        if affected == 0:
            raise EntityNotFound(pk, key)
        return f"{entity.__name__} successfully deleted with id: {key}"

    app.post(path, create)
    app.get(path, get_all)
    app.get(f"{path}/{{{pk}}}", get_one)
    app.put(f"{path}/{{{pk}}}", update)
    app.delete(f"{path}/{{{pk}}}", delete)
