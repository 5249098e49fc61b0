"""sklearn iris: train → export → serve via the Python-predictor contract.

Counterpart of ``examples/iris_sklearn.py`` (notebooks/ml/
End_To_End_Pipeline/sklearn/IrisClassification_And_Serving_SKLearn.ipynb
+ iris_flower_classifier.py, SURVEY.md §2.5): a KNN classifier trained
on iris, exported to the model registry with its metric, served with
``model_server="PYTHON"`` through a ``class Predict`` script (the
reference's escape hatch for models of any library), and queried over
the same REST payload. The classifier runs on the host, where sklearn
runs; ``device`` is checked like every example's and recorded on the
endpoint.

Usage: ``python examples_torch/iris_sklearn.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import pickle
import tempfile
from pathlib import Path

from hops_tpu_torch.modelrepo import registry, serving

MODEL_NAME = "iris_knn"

PREDICTOR_SCRIPT = '''
"""Python model server (reference contract: iris_flower_classifier.py:1-27)."""
import pickle
from pathlib import Path


class Predict:
    def __init__(self):
        bundle = Path(__file__).parent / "knn.pkl"
        self.model = pickle.loads(bundle.read_bytes())

    def predict(self, instances):
        return self.model.predict(instances).tolist()

    def classify(self, instances):
        return self.model.predict_proba(instances).tolist()
'''


def main(*, device=None) -> dict:
    from sklearn.datasets import load_iris
    from sklearn.model_selection import train_test_split
    from sklearn.neighbors import KNeighborsClassifier

    from hops_tpu_torch.runtime.devices import resolve_device

    dev = resolve_device(device)
    x, y = load_iris(return_X_y=True)
    x_train, x_test, y_train, y_test = train_test_split(x, y, random_state=0)
    knn = KNeighborsClassifier(n_neighbors=5).fit(x_train, y_train)
    acc = float(knn.score(x_test, y_test))

    # Export artifact dir = pickled model + the Predict script.
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "knn.pkl").write_bytes(pickle.dumps(knn))
        (Path(tmp) / "predictor.py").write_text(PREDICTOR_SCRIPT)
        meta = registry.export(tmp, MODEL_NAME, metrics={"accuracy": acc})

    serving.create_or_update(
        MODEL_NAME, model_name=MODEL_NAME, model_version=meta["version"],
        model_server="PYTHON", device=dev,
    )
    serving.start(MODEL_NAME)
    try:
        resp = serving.make_inference_request(
            MODEL_NAME, {"signature_name": "serving_default", "instances": x_test[:3].tolist()}
        )
        print(f"iris served: acc={acc:.3f} predictions={resp['predictions']}")
        return {"accuracy": acc, "predictions": resp["predictions"]}
    finally:
        serving.stop(MODEL_NAME)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    main(device=parser.parse_args().device)
