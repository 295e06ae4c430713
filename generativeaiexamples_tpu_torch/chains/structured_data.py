"""structured_data_rag — CSV Q&A via an LLM→pandas code-generation agent.

Behavioral parity with the reference example (ref: RAG/examples/
advanced_rag/structured_data_rag/chains.py): ingest validates CSVs and
requires matching columns across files (compare_csv_columns, chains.py:64-76;
ingested-file list chains.py:108-133); rag_chain concatenates the CSVs,
builds a column+sample-rows description (csv_utils.extract_df_desc), has the
LLM write pandas code with retries (PandasAI_Agent w/ max_retries=6,
chains.py:176-179), and paraphrases the resulting data point through the
response template (chains.py:206-215).

Differences by design: instead of PandasAI's exec-based code runner, the
generated code is validated against an AST allowlist — no imports, no
underscore attributes, `pd.<attr>` limited to a constructor/transform
allowlist (blocking the `pd.io`/`pd.read_*`/`pd.eval` escape hatches), and
IO/exec method names (`to_csv`, `query`, `eval`, `pipe`, …) rejected on any
object — then executed with a minimal namespace. This is the sandboxing the
reference delegates to the PandasAI library.

Port of ``generativeaiexamples_tpu/chains/structured_data.py``, the same in
behaviour but in one place: ``ingest_docs`` keeps a copy of each CSV under
``state_dir`` and lists that copy, where the reference lists the caller's
path. The port's chain server removes an upload once it is ingested
(ROADMAP C10), and this chain reads its CSVs again at every question. The
copy keeps the upload's file name, so ``get_documents`` answers as the
reference does and a re-upload replaces the file in place. pandas is
imported inside the functions that use it, as in the reference, so the
module imports without it.
"""

from __future__ import annotations

import ast
import logging
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, List, Sequence

from generativeaiexamples_tpu_torch.chains import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.chains.basic_rag import _sampling
from generativeaiexamples_tpu_torch.chains.context import ChainContext, get_context
from generativeaiexamples_tpu_torch.core.tracing import chain_instrumentation
from generativeaiexamples_tpu_torch.server.base import BaseExample
from generativeaiexamples_tpu_torch.server.registry import register_example

logger = logging.getLogger(__name__)

MAX_RETRIES = 6  # ref chains.py:178 — config_data_retrieval max_retries

_ALLOWED_NODES = (
    ast.Module, ast.Expr, ast.Assign, ast.AugAssign, ast.Name, ast.Load,
    ast.Store, ast.Constant, ast.Tuple, ast.List, ast.Dict, ast.Set,
    ast.Attribute, ast.Subscript, ast.Slice, ast.Index if hasattr(ast, "Index") else ast.Slice,
    ast.Call, ast.keyword, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.Invert, ast.And, ast.Or, ast.Eq,
    ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.BitAnd, ast.BitOr, ast.BitXor, ast.IfExp, ast.ListComp, ast.DictComp,
    ast.SetComp, ast.GeneratorExp, ast.comprehension, ast.Lambda,
    ast.arguments, ast.arg, ast.Starred, ast.JoinedStr, ast.FormattedValue,
)

# pd.<attr> the generated code may use: constructors and pure transforms
# only — nothing that reaches IO, eval, or submodules (pd.io.common exposes
# `os`; pd.read_* / pd.eval are filesystem/exec escapes).
_PD_ALLOWED = {
    "to_datetime", "to_numeric", "to_timedelta", "concat", "merge",
    "DataFrame", "Series", "Timestamp", "Timedelta", "NaT", "NA",
    "Grouper", "NamedAgg", "Categorical", "Index", "MultiIndex",
    "pivot_table", "crosstab", "cut", "qcut", "date_range", "unique",
    "isna", "notna", "isnull", "notnull", "get_dummies", "melt",
    "wide_to_long", "factorize", "array", "options",
}

# method/attribute names disallowed on ANY object: dataframe IO writers,
# string-eval surfaces, and module traversal hatches.
_DENIED_ATTRS = {
    "to_csv", "to_json", "to_pickle", "to_excel", "to_parquet", "to_sql",
    "to_hdf", "to_feather", "to_clipboard", "to_html", "to_latex",
    "to_xml", "to_stata", "to_orc", "to_markdown", "to_records",
    "read_csv", "read_json", "read_pickle", "read_excel", "read_parquet",
    "read_sql", "read_hdf", "read_feather", "read_html", "read_xml",
    "read_table", "read_fwf", "read_clipboard", "read_orc", "read_stata",
    "read_sas", "read_spss", "read_gbq",
    "eval", "query", "pipe", "io", "os", "sys", "builtins", "compat",
    "api", "core", "util", "testing", "errors", "tseries", "attrs",
    "style", "plot", "plotting", "globals", "getattr", "setattr",
}

_SAFE_BUILTINS = {
    "len": len, "min": min, "max": max, "sum": sum, "abs": abs,
    "round": round, "sorted": sorted, "str": str, "int": int, "float": float,
    "bool": bool, "list": list, "dict": dict, "tuple": tuple, "set": set,
    "range": range, "zip": zip, "enumerate": enumerate, "any": any,
    "all": all, "map": map, "filter": filter, "reversed": reversed,
}


def validate_code(code: str) -> ast.Module:
    """Parse + allowlist-check LLM-generated pandas code."""
    tree = ast.parse(code)
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_"):
                raise ValueError(f"disallowed attribute: {node.attr}")
            if node.attr in _DENIED_ATTRS:
                raise ValueError(f"disallowed attribute: {node.attr}")
            if (isinstance(node.value, ast.Name) and node.value.id == "pd"
                    and node.attr not in _PD_ALLOWED):
                raise ValueError(f"disallowed pandas attribute: {node.attr}")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ValueError(f"disallowed name: {node.id}")
    return tree


def run_pandas_code(code: str, df) -> Any:
    """Execute validated code with only {df, pd, builtins-allowlist};
    the answer is `result` (or the last expression's value)."""
    import pandas as pd

    tree = validate_code(code)
    # make a bare trailing expression become `result`
    if tree.body and isinstance(tree.body[-1], ast.Expr):
        tree.body[-1] = ast.Assign(
            targets=[ast.Name(id="result", ctx=ast.Store())],
            value=tree.body[-1].value)
        ast.fix_missing_locations(tree)
    namespace: Dict[str, Any] = {"df": df, "dfs": [df], "pd": pd,
                                 "__builtins__": _SAFE_BUILTINS}
    exec(compile(tree, "<llm-pandas>", "exec"), namespace)  # noqa: S102
    return namespace.get("result")


def extract_df_desc(df) -> str:
    """Column names + up to 3 sample rows (ref csv_utils.extract_df_desc,
    csv_utils.py:26-40; head() instead of sample() for determinism)."""
    column_names = ", ".join(df.columns)
    rows_str = df.head(3).to_string(header=False, index=False)
    return column_names + "\n" + rows_str


def strip_code_fences(text: str) -> str:
    text = text.strip()
    if text.startswith("```"):
        lines = text.split("\n")
        lines = lines[1:]
        if lines and lines[-1].strip().startswith("```"):
            lines = lines[:-1]
        text = "\n".join(lines)
    return text.strip()


def is_result_valid(result: Any) -> bool:
    """ref csv_utils.is_result_valid, csv_utils.py:115-119."""
    import pandas as pd

    if isinstance(result, pd.DataFrame):
        return not result.empty
    if isinstance(result, pd.Series):
        return len(result) > 0
    return result is not None and bool(str(result))


@register_example("structured_data_rag")
class StructuredDataRAG(BaseExample):
    """CSV chatbot (ref CSVChatbot, chains.py:60)."""

    def __init__(self, context: ChainContext = None,
                 state_dir: str = "") -> None:
        self.ctx = context or get_context()
        self.state_dir = state_dir or os.environ.get(
            "APP_STATE_DIR", os.path.join(tempfile.gettempdir(),
                                          "generativeaiexamples_tpu_torch"))
        os.makedirs(self.state_dir, exist_ok=True)
        self.files_list = os.path.join(self.state_dir,
                                       "ingested_csv_files.txt")
        self.csv_dir = os.path.join(self.state_dir, "csv_files")

    # ------------------------------------------------------------ ingestion

    def _csv_paths(self) -> List[str]:
        if not os.path.exists(self.files_list):
            return []
        with open(self.files_list, "r", encoding="utf-8") as fh:
            return [l.strip() for l in fh.read().splitlines() if l.strip()]

    @chain_instrumentation
    def ingest_docs(self, filepath: str, filename: str) -> None:
        import pandas as pd

        if not filename.lower().endswith(".csv"):
            raise ValueError(f"{filename} is not a valid CSV file")
        paths = self._csv_paths()
        if paths:  # column compatibility (ref compare_csv_columns)
            ref_df = pd.read_csv(paths[0], nrows=1)
            new_df = pd.read_csv(filepath, nrows=1)
            if not new_df.columns.equals(ref_df.columns):
                raise ValueError(
                    f"Columns of the file {filepath} do not match the "
                    f"reference columns of {paths[0]} file.")
        else:
            pd.read_csv(filepath, nrows=1)  # must parse
        # the chain's own copy: the server removes its upload once ingested
        os.makedirs(self.csv_dir, exist_ok=True)
        kept = os.path.join(self.csv_dir, os.path.basename(filepath))
        staged = f"{kept}.{uuid.uuid4().hex}.partial"
        shutil.copyfile(filepath, staged)
        os.replace(staged, kept)
        if kept not in paths:  # re-upload replaces in place, no dup rows
            with open(self.files_list, "a", encoding="utf-8") as fh:
                fh.write(kept + "\n")
        logger.info("Document %s ingested successfully", filename)

    def _load_df(self):
        """Read + concatenate all ingested CSVs
        (ref read_and_concatenate_csv, chains.py:78-106)."""
        import pandas as pd

        paths = self._csv_paths()
        if not paths:
            return None
        frames = [pd.read_csv(p) for p in paths]
        ref_cols = frames[0].columns
        for path, frame in zip(paths[1:], frames[1:]):
            if not frame.columns.equals(ref_cols):
                raise ValueError(
                    f"Columns of the file {path} do not match the reference "
                    f"columns of {paths[0]} file.")
        return pd.concat(frames, ignore_index=True).fillna(0)

    # ----------------------------------------------------------- generation

    @chain_instrumentation
    def llm_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        messages = [{"role": "system",
                     "content": self.ctx.prompts["chat_template"]},
                    {"role": "user", "content": query}]
        yield from self.ctx.llm.chat(messages, **_sampling(llm_settings))

    def _generate_result(self, df, query: str, **settings: Any) -> Any:
        """LLM writes pandas code; retry with error feedback
        (PandasAI-agent equivalent, ref chains.py:176-200)."""
        csv_name = os.environ.get("CSV_NAME", "")
        description, instructions = csv_name or "a CSV table", "- none"
        for p in self.ctx.prompts.get("csv_prompts", []) or []:
            if isinstance(p, dict) and p.get("name") == csv_name:
                description = p.get("description", description)
                instructions = p.get("instructions", instructions)
        system = self.ctx.prompts["csv_data_retrieval_template"].format(
            description=description, instructions=instructions,
            data_frame=extract_df_desc(df))
        error = ""
        s = _sampling(settings)
        s["temperature"] = 0.2  # ref: PandasAI_NVIDIA(temperature=0.2)
        s["max_tokens"] = min(s["max_tokens"], 384)
        for attempt in range(MAX_RETRIES):
            user = query if not error else (
                f"{query}\n\nYour previous code failed with: {error}\n"
                f"Write corrected code.")
            raw = "".join(self.ctx.llm.chat(
                [{"role": "system", "content": system},
                 {"role": "user", "content": user}], **s))
            code = strip_code_fences(raw)
            try:
                result = run_pandas_code(code, df)
                if is_result_valid(result):
                    return result
                error = "result was empty or None"
            except Exception as exc:
                error = str(exc)
                logger.info("pandas code attempt %d failed: %s",
                            attempt + 1, error)
        return None

    @chain_instrumentation
    def rag_chain(self, query: str, chat_history: Sequence[Dict[str, str]],
                  **llm_settings: Any) -> Iterator[str]:
        df = self._load_df()
        if df is None:
            yield "No CSV file ingested"  # ref chains.py:166
            return
        result = self._generate_result(df, query, **llm_settings)
        if not is_result_valid(result):
            yield NO_CONTEXT_MSG
            return
        logger.info("Result data point: %s", result)
        prompt = self.ctx.prompts["csv_response_template"].format(
            query=query, data=str(result))
        yield from self.ctx.llm.chat(
            [{"role": "user", "content": prompt}], **_sampling(llm_settings))

    # ------------------------------------------------------------ documents

    def get_documents(self) -> List[str]:
        return [os.path.basename(p) for p in self._csv_paths()]

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        names = set(filenames)
        paths = self._csv_paths()
        keep = [p for p in paths if os.path.basename(p) not in names]
        if len(keep) == len(paths):
            return False
        with open(self.files_list, "w", encoding="utf-8") as fh:
            fh.write("".join(p + "\n" for p in keep))
        for path in paths:
            if path not in keep and os.path.dirname(path) == self.csv_dir:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
        return True
