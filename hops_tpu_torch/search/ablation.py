"""Ablation studies: LOCO (leave-one-component-out) (a copy of
``hops_tpu/search/ablation.py``: the module imports no JAX, and the port imports nothing
of the JAX package).

Reference surface (maggy-ablation-titanic-example.ipynb:135+, SURVEY.md
§2.4): an :class:`AblationStudy` names a training dataset and collects
included features / model layers / layer groups plus a base-model
generator; the ``loco`` ablator expands it into one trial per ablated
component (plus the un-ablated base trial).

Trial contract here: the train fn is called as
``train_fn(ablated_feature=..., ablated_layer=..., reporter=...)`` with
``None`` meaning "nothing ablated"; generators registered on the study
are available to the fn via the study object itself.
"""

from __future__ import annotations

from typing import Any, Callable


class _Features:
    def __init__(self) -> None:
        self.included: list[str] = []

    def include(self, *names: str | list[str]) -> None:
        for n in names:
            if isinstance(n, (list, tuple)):
                self.included.extend(n)
            else:
                self.included.append(n)

    def exclude(self, *names: str) -> None:
        for n in names:
            if n in self.included:
                self.included.remove(n)

    def list_all(self) -> list[str]:
        return list(self.included)


class _Layers:
    def __init__(self) -> None:
        self.included: list[str] = []
        self.groups: list[tuple[str, ...]] = []
        self._prefixes: list[str] = []

    def include(self, *names: str | list[str]) -> None:
        for n in names:
            if isinstance(n, (list, tuple)):
                self.included.extend(n)
            else:
                self.included.append(n)

    def include_groups(self, *groups: list[str], prefix: str | None = None) -> None:
        """A group ablates together; ``prefix=`` groups all *included*
        layers whose name starts with it (reference:
        include_groups(prefix='conv')). Prefixes are expanded against
        the names registered via :meth:`include` when trials are
        generated."""
        for g in groups:
            self.groups.append(tuple(g))
        if prefix is not None:
            self._prefixes.append(prefix)


class _ModelSpec:
    def __init__(self) -> None:
        self.layers = _Layers()
        self._base_model_generator: Callable[..., Any] | None = None

    def set_base_model_generator(self, fn: Callable[..., Any]) -> None:
        self._base_model_generator = fn

    @property
    def base_model_generator(self) -> Callable[..., Any] | None:
        return self._base_model_generator


class AblationStudy:
    def __init__(
        self,
        training_dataset_name: str,
        training_dataset_version: int = 1,
        label_name: str | None = None,
    ):
        self.training_dataset_name = training_dataset_name
        self.training_dataset_version = training_dataset_version
        self.label_name = label_name
        self.features = _Features()
        self.model = _ModelSpec()
        self._dataset_generator: Callable[..., Any] | None = None

    def set_dataset_generator(self, fn: Callable[..., Any]) -> None:
        self._dataset_generator = fn

    @property
    def dataset_generator(self) -> Callable[..., Any] | None:
        return self._dataset_generator


class LOCOAblator:
    """Expand a study into leave-one-out trial configs (LOCO semantics:
    maggy-ablation-titanic-example.ipynb:434)."""

    def __init__(self, study: AblationStudy):
        self.study = study

    def trials(self) -> list[dict[str, Any]]:
        layers = self.study.model.layers
        out: list[dict[str, Any]] = [{"ablated_feature": None, "ablated_layer": None}]
        for feat in self.study.features.included:
            out.append({"ablated_feature": feat, "ablated_layer": None})
        for layer in layers.included:
            out.append({"ablated_feature": None, "ablated_layer": layer})
        for group in layers.groups:
            out.append({"ablated_feature": None, "ablated_layer": list(group)})
        for prefix in layers._prefixes:
            matches = [n for n in layers.included if n.startswith(prefix)]
            if not matches:
                raise ValueError(
                    f"include_groups(prefix={prefix!r}) matched no included layer; "
                    "register layer names via model.layers.include(...) first"
                )
            out.append({"ablated_feature": None, "ablated_layer": matches})
        return out
